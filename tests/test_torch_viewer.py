"""The port's viewer (coulomb_oscillators_tpu_torch/scripts/view.py): every
case of tests/test_viewer.py on snapshots written by the port's
utils/io.py, and its frames byte-equal to the original scripts/view.py's
on the same files.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from coulomb_oscillators_tpu_torch.scripts import view
from coulomb_oscillators_tpu_torch.utils import io as cio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import view as jview  # noqa: E402  (the original, by path as its tests do)


def test_read_snapshot_infers_n_like_viewer(tmp_path):
    # viewer math (main.cpp:184): nBodies = bytes / 4 / sizeof(double)
    n, dim = 137, 2
    pos = np.arange(n * dim, dtype=np.float64).reshape(n, dim)
    vel = -pos
    path = cio.snapshot_name(str(tmp_path), 0, 0.005)
    cio.write_state(path, pos, vel)
    nbytes = os.path.getsize(path)
    assert nbytes // 4 // 8 == n
    got = view.read_snapshot(path, dim, np.float64)
    np.testing.assert_array_equal(got, pos)


def test_read_snapshot_rejects_a_ragged_file(tmp_path):
    path = str(tmp_path / "bad.bin")
    np.arange(7, dtype=np.float64).tofile(path)
    with pytest.raises(ValueError):
        view.read_snapshot(path, 2, np.float64)


def test_reference_transform_pixel_positions():
    # a particle at NDC (+0.5, +0.5) must land at pixel (3/4 side, 1/4 side)
    s = view.REF_SCALE
    pos = np.array([[0.5 / s, 0.5 / s], [0.0, 0.0]])
    img = view.render_frame(pos)
    side = view.REF_SIDE
    assert img[side // 4, (3 * side) // 4, 0] == 255
    assert img[side // 2, side // 2, 0] == 255       # origin -> center
    assert img[..., 1:].max() == 0                   # red-only points


def test_out_of_window_points_clipped():
    pos = np.array([[10.0, 10.0]])                   # far outside NDC
    img = view.render_frame(pos, scale=1.0)
    assert img.max() == 0


def _decode_png(path):
    """(width, height, rows) of an 8-bit RGB PNG with filter-0 rows."""
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    idat = raw[raw.index(b"IDAT") + 4:raw.rindex(b"IEND") - 4]
    dec = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = dec.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return w, h, rows[:, 1:].reshape(h, w, 3)


def test_png_roundtrip(tmp_path):
    img = view.render_frame(np.zeros((1, 2)), scale=1.0)
    path = str(tmp_path / "frame.png")
    view.write_png(path, img)
    w, h, rgb = _decode_png(path)
    assert (w, h) == (view.REF_SIDE, view.REF_SIDE)
    assert np.array_equal(rgb, img)
    # the center pixel is red
    assert tuple(rgb[h // 2, w // 2]) == (255, 0, 0)


def test_iteration_overlay():
    # reference draws std::to_string(iter) in green at GL (24, 24)
    # (Graphics/main.cpp:214-219); glyph pixels are green-only and sit in
    # the bottom-left corner (GL origin = bottom-left)
    img = view.render_frame(np.zeros((0, 2)), scale=1.0)
    view.draw_text(img, "120", 24, 24)
    assert img[..., 1].max() == 255          # green on
    assert img[..., 0].max() == 0            # no red from the overlay
    ys, xs = np.nonzero(img[..., 1])
    side = view.REF_SIDE
    assert ys.min() >= side - 24 - 7 * 2 - 2 and ys.max() <= side - 1 - 24 + 1
    assert xs.min() >= 24 and xs.max() <= 24 + 3 * 6 * 2
    # digits differ: "0" and "1" must not rasterize identically
    a = view.render_frame(np.zeros((0, 2)), scale=1.0)
    view.draw_text(a, "0", 24, 24)
    b = view.render_frame(np.zeros((0, 2)), scale=1.0)
    view.draw_text(b, "1", 24, 24)
    assert (a != b).any()


def _write_snaps(outdir, dim, dtype, its, dt, scale):
    rng = np.random.default_rng(7)
    os.makedirs(outdir)
    for it in its:
        pos = (rng.normal(size=(64, dim)) * scale).astype(dtype)
        vel = (rng.normal(size=(64, dim)) * scale).astype(dtype)
        cio.write_state(cio.snapshot_name(str(outdir), it, dt), pos, vel)


def test_end_to_end_frames(tmp_path):
    # two snapshots out0/out20 like a stride-20 run, rendered via main()
    outdir = tmp_path / "snaps"
    _write_snaps(outdir, 2, np.float64, (0, 20), 0.005, 2e-9)
    imgdir = tmp_path / "img"
    rc = view.main([str(outdir), "-o", str(imgdir), "--max-frames", "5"])
    assert rc == 0
    assert (imgdir / "image0.png").exists()
    assert (imgdir / "image1.png").exists()
    assert not (imgdir / "image2.png").exists()
    w, h, rgb = _decode_png(str(imgdir / "image1.png"))
    assert (w, h) == (792, 792) and rgb[..., 0].any() and rgb[..., 1].any()


def test_no_snapshots_is_a_failure(tmp_path):
    assert view.main([str(tmp_path), "-o", str(tmp_path / "img"),
                      "--max-frames", "3"]) == 1


@pytest.mark.parametrize("dim,dtype,flags", [
    (2, np.float64, []),
    (3, np.float32, ["--dim", "3", "--dtype", "f4", "--scale", "auto",
                     "--dt", "0.0005", "--stride", "10"]),
    (3, np.float32, ["--dim", "3", "--dtype", "f4", "--scale", "40.0",
                     "--dt", "0.0005", "--stride", "10", "--no-overlay",
                     "--label", "it {it} t={t:.4f}"]),
], ids=["2d_f8_ref", "3d_f4_auto", "3d_f4_label"])
def test_frames_byte_equal_the_originals(tmp_path, dim, dtype, flags):
    """Same snapshot files, same flags: the port's PNG files equal the
    original viewer's byte for byte."""
    three = dim == 3
    outdir = tmp_path / "snaps"
    _write_snaps(outdir, dim, dtype, (0, 10, 20) if three else (0, 20, 40),
                 0.0005 if three else 0.005, 0.01 if three else 2e-9)
    a, b = tmp_path / "img_port", tmp_path / "img_orig"
    assert view.main([str(outdir), "-o", str(a)] + flags) == 0
    assert jview.main([str(outdir), "-o", str(b)] + flags) == 0
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) == [f"image{k}.png"
                                              for k in range(3)]
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_viewer_runs_as_a_module_on_the_ports_cli_snapshots(tmp_path):
    """The port's CLI writes snapshots, `python -m ...scripts.view` renders
    them in a process that never imports JAX."""
    from coulomb_oscillators_tpu_torch import cli
    out = tmp_path / "run"
    assert cli.main(["-n", "64", "-iters", "10", "-steps", "10", "-engine",
                     "direct", "-o", str(out), "-cpu"]) == 0
    img = tmp_path / "img"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = ("import sys\n"
            "from coulomb_oscillators_tpu_torch.scripts import view\n"
            "rc = view.main(sys.argv[1:])\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith('coulomb_oscillators_tpu.')]\n"
            "sys.exit(rc)\n")
    res = subprocess.run(
        [sys.executable, "-c", code, str(out), "-o", str(img), "--dim", "3",
         "--dtype", "f4", "--dt", "0.0005", "--stride", "10", "--scale",
         "auto"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert "rendered 2 frames" in res.stdout
    for k in (0, 1):
        w, h, rgb = _decode_png(str(img / f"image{k}.png"))
        assert (w, h) == (792, 792) and rgb[..., 0].any()
