"""Port parity: the image codecs and the stack exporter
(volumeraytracer_tpu_torch.utils.image_io and .jpeg, numpy and the standard
library only) against the JAX package's: the same arrays give the same
bytes, each package reads the other's files, and the cases of
tests/test_image_io.py hold for the port."""

import numpy as np
import pytest

from volumeraytracer_tpu.utils import image_io as jax_image_io
from volumeraytracer_tpu.utils import jpeg as jax_jpeg
from volumeraytracer_tpu_torch.utils import image_io, jpeg


def _image(channels, seed, shape=(13, 17)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape if channels == 1 else shape + (channels,), dtype=np.uint8)


def _photo(h=72, w=100):
    """tests/test_image_io.py's smooth gray image and its RGB companion."""
    yy, xx = np.mgrid[0:h, 0:w]
    gray = ((np.sin(xx / 17.0) + np.cos(yy / 11.0)) * 55 + 128).clip(0, 255).astype(np.uint8)
    rgb = np.stack([gray, 255 - gray, (xx * 255 // w).astype(np.uint8)], -1)
    return gray, rgb


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_same_bytes_and_cross_read(tmp_path, channels):
    img = _image(channels, seed=10 + channels)
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    image_io.write_png(ours, img)
    jax_image_io.write_png(theirs, img)
    assert ours.read_bytes() == theirs.read_bytes()
    want = img.reshape(13, 17, channels)
    np.testing.assert_array_equal(image_io.read_png(theirs), want)
    np.testing.assert_array_equal(jax_image_io.read_png(ours), want)


@pytest.mark.parametrize("quality", [90, 50])
@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_jpeg_same_bytes_and_cross_read(tmp_path, quality, kind):
    gray, rgb = _photo()
    img = gray if kind == "gray" else rgb
    ours, theirs = tmp_path / "port.jpg", tmp_path / "jax.jpg"
    jpeg.write_jpeg(ours, img, quality=quality)
    jax_jpeg.write_jpeg(theirs, img, quality=quality)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(jpeg.read_jpeg(theirs), jax_jpeg.read_jpeg(ours))
    assert image_io.read_jpeg is jpeg.read_jpeg and image_io.write_jpeg is jpeg.write_jpeg


@pytest.mark.parametrize("fmt, ext", [("png", "png"), ("jpeg", "jpg")])
def test_export_image_stack_same_files(tmp_path, fmt, ext):
    """3-D along axis 1 and 2-D, both formats: the same files as JAX's."""
    vol = np.linspace(0.0, 1.0, 4 * 16 * 16, dtype=np.float32).reshape(4, 16, 16) ** 2
    for name, volume, axis in (("v3", vol, 1), ("v2", vol[2], 0)):
        n = image_io.export_image_stack(tmp_path / "port", volume, prefix=name, axis=axis, format=fmt)
        m = jax_image_io.export_image_stack(tmp_path / "jax", volume, prefix=name, axis=axis, format=fmt)
        assert n == m == (16 if volume.ndim == 3 else 1)
        for i in range(n):
            f = f"{name}_{i:04d}.{ext}"
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_to_uint8_matches_jax():
    f = np.random.default_rng(3).normal(size=(7, 9)).astype(np.float32)
    for lo, hi in ((None, None), (-0.5, 0.5), (1.0, 1.0)):
        np.testing.assert_array_equal(image_io.to_uint8(f, lo, hi), jax_image_io.to_uint8(f, lo, hi))


# tests/test_image_io.py's cases, on the port


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, channels):
    img = _image(channels, seed=channels)
    f = tmp_path / "t.png"
    image_io.write_png(f, img)
    np.testing.assert_array_equal(image_io.read_png(f), img.reshape(13, 17, channels))


def test_png_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError):
        image_io.write_png(tmp_path / "x.png", np.zeros((4, 4), np.float32))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        image_io.read_png(bad)


def test_export_image_stack(tmp_path):
    vol = np.linspace(0.0, 1.0, 4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    assert image_io.export_image_stack(tmp_path / "stack", vol) == 4
    files = sorted((tmp_path / "stack").glob("slice_*.png"))
    assert len(files) == 4
    first, last = image_io.read_png(files[0]), image_io.read_png(files[-1])
    assert first.shape == (5, 6, 1)
    assert first.mean() < last.mean() and last.max() == 255


def test_export_2d(tmp_path):
    img = np.arange(30, dtype=np.float32).reshape(5, 6)
    assert image_io.export_image_stack(tmp_path, img, prefix="f") == 1
    assert image_io.read_png(tmp_path / "f_0000.png").shape == (5, 6, 1)


def test_jpeg_roundtrip(tmp_path):
    """Within tests/test_image_io.py's lossy tolerance (mean error < 3)."""
    gray, rgb = _photo()
    for name, img in (("g.jpg", gray), ("c.jpg", rgb)):
        p = tmp_path / name
        jpeg.write_jpeg(p, img, quality=92)
        back = jpeg.read_jpeg(p)
        assert back.shape == img.shape
        assert np.abs(back.astype(float) - img.astype(float)).mean() < 3.0


def test_jpeg_cross_decoder_pil(tmp_path):
    """libjpeg (through PIL) decodes the port's files, and the port decodes
    libjpeg's, 4:2:0 subsampling and an odd size included."""
    Image = pytest.importorskip("PIL.Image")
    h, w = 72, 100
    _, rgb = _photo(h, w)
    ours = tmp_path / "c.jpg"
    jpeg.write_jpeg(ours, rgb, quality=92)
    pil = np.asarray(Image.open(ours).convert("RGB"))
    assert np.abs(pil.astype(float) - rgb.astype(float)).mean() < 3.0
    p = tmp_path / "pil420.jpg"
    Image.fromarray(rgb[: h - 3, : w - 5]).save(p, quality=88, subsampling=2)
    dec = jpeg.read_jpeg(p)
    assert dec.shape == (h - 3, w - 5, 3)
    assert np.abs(dec.astype(float) - np.asarray(Image.open(p)).astype(float)).mean() < 3.0


def test_jpeg_rejects_garbage(tmp_path):
    p = tmp_path / "bad.jpg"
    p.write_bytes(b"not a jpeg at all")
    with pytest.raises(ValueError):
        jpeg.read_jpeg(p)


def test_export_image_stack_jpeg(tmp_path):
    vol = np.linspace(0, 1, 4 * 16 * 16, dtype=np.float32).reshape(4, 16, 16)
    assert image_io.export_image_stack(tmp_path, vol, format="jpeg") == 4
    assert image_io.read_jpeg(tmp_path / "slice_0000.jpg").shape == (16, 16)
    with pytest.raises(ValueError):
        image_io.export_image_stack(tmp_path, vol, format="bmp")
