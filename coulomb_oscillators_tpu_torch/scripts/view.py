"""Snapshot viewer: renders `out<iter>_<dt>.bin` files to PNG frames.

Twin of ``scripts/view.py`` with the port's own font, so it starts on a
machine without JAX; same flags, same PNG bytes.  Like the original it
closes the reference's L6 layer (Graphics/main.cpp): instead of an OpenGL
window + FreeImage BMP dump, it renders the same frames headlessly to PNGs
(host only, numpy + zlib).

Parsing and transform mirror Graphics/main.cpp exactly:
  * file = raw dump of positions then velocities, scalars of `--dtype`
    (double for the 2D simulator, float for the 3D one; main.cpp:180 reads
    doubles because the reference viewer targets the 2D beam sim);
  * nBodies inferred from the byte count (main.cpp:184: bytes/4/sizeof(scal)
    for dim=2 — equivalently bytes/(2*dim*sizeof));
  * only positions are drawn, first 2 coordinates per particle
    (main.cpp:199-207: vertex attrib of 2 floats over the position half);
  * world -> NDC scale factor 10e4 * 250 ("window side = 2*4 mm = 8 mm",
    main.cpp:183), window 792x792 (main.cpp:126), red points on black
    (vertex.vsh/fragment.fsh), frame files img/image<iter> (main.cpp:226-241);
  * frame k reads out<k*stride>_<dt>.bin with stride 20, dt 0.005
    (main.cpp:155) — both are flags here instead of hard-codes.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.view <snapshot-dir>
      [-o img] [--dt 0.005] [--stride 20] [--dim 2] [--dtype f8]
      [--scale auto|REF|<float>]
"""

import argparse
import os
import struct
import sys
import zlib

import numpy as np

# full printable-ASCII 5x7 text engine — the headless equivalent of the
# reference's FreeType atlas + Text quads (Graphics/Font.hpp:40-358)
from coulomb_oscillators_tpu_torch.utils.font import draw_text

REF_SCALE = 10e4 * 250.0        # main.cpp:183 (10e4 == 1e5 in C++)
REF_SIDE = 792                  # main.cpp:126


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG encoder (8-bit RGB), no external deps."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", hdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def render_frame(pos: np.ndarray, scale: float = REF_SCALE,
                 side: int = REF_SIDE) -> np.ndarray:
    """Rasterize particle positions like the reference's GL_POINTS pass.

    pos: [N, dim] (first 2 coords drawn); returns [side, side, 3] uint8,
    red points on black, y up (GL convention), points outside NDC clipped.
    """
    ndc = np.asarray(pos[:, :2], np.float64) * scale
    keep = (np.abs(ndc[:, 0]) <= 1.0) & (np.abs(ndc[:, 1]) <= 1.0)
    ndc = ndc[keep]
    px = np.clip(((ndc[:, 0] + 1.0) * 0.5 * side).astype(np.int64),
                 0, side - 1)
    py = np.clip(((1.0 - (ndc[:, 1] + 1.0) * 0.5) * side).astype(np.int64),
                 0, side - 1)
    img = np.zeros((side, side, 3), np.uint8)
    img[py, px, 0] = 255
    return img


def read_snapshot(path: str, dim: int, dtype) -> np.ndarray:
    """Positions from a snapshot, inferring N from the byte count exactly
    like the viewer (main.cpp:184) / simulator (main3.cu:636)."""
    raw = np.fromfile(path, dtype=dtype)
    if raw.size % (2 * dim) != 0:
        raise ValueError(f"{path}: {raw.size} scalars not divisible by "
                         f"2*dim={2 * dim}")
    n = raw.size // (2 * dim)
    return raw[: n * dim].reshape(n, dim)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("indir", help="directory of out<k>_<dt>.bin snapshots")
    ap.add_argument("-o", "--outdir", default="img")
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--stride", type=int, default=20)
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--dtype", default="f8", choices=("f4", "f8"),
                    help="snapshot scalar (f8 = 2D runs, f4 = 3D runs)")
    ap.add_argument("--scale", default="REF",
                    help="'REF' (10e4*250, main.cpp:183), 'auto' (fit the "
                         "cloud), or a float")
    ap.add_argument("--max-frames", type=int, default=10_000)
    ap.add_argument("--no-overlay", action="store_true",
                    help="disable the iteration-number overlay")
    ap.add_argument("--label", default=None,
                    help="extra text drawn top-left (any printable ASCII; "
                         "'{it}'/'{t}' expand to iteration / sim time)")
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    dtype = np.float64 if args.dtype == "f8" else np.float32
    rendered = 0
    for k in range(args.max_frames):
        it = k * args.stride
        path = os.path.join(args.indir, f"out{it}_{args.dt:.6f}.bin")
        if not os.path.exists(path):
            if rendered == 0:
                continue   # allow a late simulation start
            print(f"Iteration {it} does not have an associated input file.")
            break
        pos = read_snapshot(path, args.dim, dtype)
        if args.scale == "REF":
            scale = REF_SCALE
        elif args.scale == "auto":
            ext = np.abs(pos[:, :2]).max() or 1.0
            scale = 0.9 / ext
        else:
            scale = float(args.scale)
        img = render_frame(pos, scale)
        if not args.no_overlay:
            draw_text(img, str(it), 24, 24)   # main.cpp:214-219 parity
        if args.label:
            text = args.label.format(it=it, t=it * args.dt)
            draw_text(img, text, 8, img.shape[0] - 24, scale=2)
        out = os.path.join(args.outdir, f"image{k}.png")
        write_png(out, img)
        rendered += 1
    print(f"rendered {rendered} frames -> {args.outdir}/")
    return 0 if rendered else 1


if __name__ == "__main__":
    sys.exit(main())
