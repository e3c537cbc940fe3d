"""The port's C++ host runtime (multimodal_auv_torch/native/: its own copy of
the JAX package's native/csrc/auvnative.cpp, built with g++ at first use
into the kernels' build directory), following tests/test_native.py: each
function byte-equal to the JAX package's ``multimodal_auv_tpu.native.lib``
on the same inputs, and to the port's own fallback where it has one that
computes the same bytes (LZW: ``dataprep/geotiff.py::_lzw_decode``;
accumulate and window copy: numpy; decode: PIL's decode and convert, then
the native resize, which is ``load_image_u8``'s path where the runtime has
no decoder). The resize has no byte-equal fallback (PIL's bilinear filter
antialiases a downscale): it is held to cv2's INTER_LINEAR within the JAX
test's bound; normalise to numpy within its 1e-5. The decode cases skip
when the runtime was built without libjpeg / libpng.
"""
import numpy as np
import pytest

from multimodal_auv_torch import native
from multimodal_auv_torch.data import transforms as T
from multimodal_auv_torch.dataprep import geotiff as G
from multimodal_auv_torch.ops.kernels import build_dir
from multimodal_auv_tpu import native as jnative
from multimodal_auv_tpu.data import transforms as JT
from tests.lzw_ref import lzw_encode


@pytest.fixture(scope="module")
def lib():
    if native.lib is None:
        pytest.skip("no C++ toolchain: the port's host runtime did not build")
    return native.lib


@pytest.fixture(scope="module")
def jlib():
    if jnative.lib is None:
        pytest.skip("the JAX package's native library did not build")
    return jnative.lib


@pytest.fixture(scope="module")
def decode_lib(lib, jlib):
    if not (lib.has_decode and jlib.has_decode):
        pytest.skip("native decode unavailable (not linked with "
                    "libjpeg/libpng)")
    return lib


def test_built_into_the_build_directory(lib):
    """The library is the port's own build, in ``build_dir()`` keyed by a
    hash of its source and flags, not beside the source or the JAX
    package's ``libauvnative.so``."""
    path = lib._c._name
    assert path.startswith(str(build_dir()))
    assert path.rsplit("/", 1)[-1].startswith("libauvnative_")
    assert "multimodal_auv_tpu" not in path


@pytest.mark.parametrize("shape,dh,dw", [((3, 64, 48, 3), 256, 256),
                                         ((2, 300, 260, 1), 96, 80),
                                         ((1, 17, 33, 3), 17, 33)])
def test_resize_equals_jax_and_cv2(lib, jlib, shape, dh, dw):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, shape, np.uint8)
    out = lib.resize_batch(imgs, dh, dw)
    assert out.shape == (shape[0], dh, dw, shape[3])
    np.testing.assert_array_equal(out, jlib.resize_batch(imgs, dh, dw))
    np.testing.assert_array_equal(out, lib.resize_batch(imgs, dh, dw,
                                                        nthreads=1))
    cv2 = pytest.importorskip("cv2")
    ref = cv2.resize(imgs[0], (dw, dh), interpolation=cv2.INTER_LINEAR)
    diff = np.abs(out[0].astype(int) - ref.reshape(out[0].shape).astype(int))
    assert diff.mean() < 1.0 and diff.max() <= 2  # rounding-level agreement


def test_normalize_equals_jax(lib, jlib):
    from multimodal_auv_torch.config import OPTICAL_MEAN, OPTICAL_STD

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 5, 7, 3), np.uint8)
    out = lib.normalize(img, OPTICAL_MEAN, OPTICAL_STD)
    np.testing.assert_array_equal(out, jlib.normalize(img, OPTICAL_MEAN,
                                                      OPTICAL_STD))
    ref = T.normalize_optical(img.astype(np.float32) / 255.0)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_accumulate_equals_jax_and_numpy(lib, jlib):
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (8, 8, 3), np.uint8) for _ in range(5)]
    acc, jacc = np.zeros((8, 8, 3)), np.zeros((8, 8, 3))
    for im in imgs:
        lib.accumulate(im, acc)
        jlib.accumulate(im, jacc)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(acc, np.sum([i.astype(np.float64)
                                               for i in imgs], axis=0))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
@pytest.mark.parametrize("off", [(-2, 7), (3, -4), (0, 0), (8, 8), (20, 1)])
def test_window_copy_equals_jax_and_numpy(lib, jlib, dtype, off):
    """Clipped windows (rows or columns outside the source keep the fill),
    as numpy slicing gives them."""
    src = np.arange(100).astype(dtype).reshape(10, 10)
    dst, jdst = (np.full((6, 6), 7, dtype) for _ in range(2))
    lib.window_copy(src, dst, *off)
    jlib.window_copy(src, jdst, *off)
    np.testing.assert_array_equal(dst, jdst)
    ref = np.full((6, 6), 7, dtype)
    r0, c0 = max(off[0], 0), max(off[1], 0)
    r1, c1 = min(off[0] + 6, 10), min(off[1] + 6, 10)
    if r1 > r0 and c1 > c0:
        ref[r0 - off[0]:r1 - off[0], c0 - off[1]:c1 - off[1]] = \
            src[r0:r1, c0:c1]
    np.testing.assert_array_equal(dst, ref)


def test_lzw_differential_across_code_widths(lib, jlib):
    """The native decoder, the JAX package's and the port's Python fallback
    on payloads whose string tables cross every code width (9 -> 10 -> 11
    -> 12 bits and the 4096 clear), from the shared test encoder and the
    port's own (libtiff's) encoder; a truncated stream decodes short in
    both, a corrupt one raises."""
    rng = np.random.default_rng(7)
    for trial, (alphabet, n) in enumerate([(2, 3000), (256, 30000),
                                           (8, 120000), (1, 9000),
                                           (16, 20000)]):
        payload = bytes(rng.integers(0, alphabet, size=n, dtype=np.uint8))
        for enc in (lzw_encode(payload), G._lzw_encode(payload)):
            got = lib.lzw_decode(enc, n)
            assert got == payload, f"native decoder diverged (trial {trial})"
            assert jlib.lzw_decode(enc, n) == got
            assert G._lzw_decode(enc, n) == got
    enc = lzw_encode(payload)
    short = enc[:len(enc) // 2]
    assert lib.lzw_decode(short, n) == G._lzw_decode(short, n)
    assert len(lib.lzw_decode(short, n)) < n
    with pytest.raises(ValueError, match="corrupt"):
        lib.lzw_decode(bytes([0x81, 0, 0, 0]), 16)  # first code 258


def test_geotiff_lzw_reads_through_native(lib, monkeypatch, tmp_path):
    """``GeoTiff.read`` decodes an LZW raster's strips through the native
    decoder (``_native_or_py_lzw``), with the pixels the Python fallback
    reads."""
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (64, 48, 2)).astype(np.uint8)
    path = G.write_geotiff(str(tmp_path / "b.tif"), data,
                           (0.0, 0.5, 0.0, 10.0, 0.0, -0.5),
                           compression="lzw", predictor=2,
                           rows_per_strip=16)
    calls = []

    class Spy:
        def lzw_decode(self, raw, expected):
            calls.append(expected)
            return lib.lzw_decode(raw, expected)

    monkeypatch.setattr(native, "lib", Spy())
    got = np.stack([G.GeoTiff.open(path).read(b) for b in range(2)], -1)
    assert len(calls) == 8  # 4 strips, decoded for each of 2 band reads
    np.testing.assert_array_equal(got, data)
    monkeypatch.setattr(native, "lib", None)
    np.testing.assert_array_equal(
        np.stack([G.GeoTiff.open(path).read(b) for b in range(2)], -1), data)


def _pil_chain(path, mode, dh, dw, lib):
    """PIL's decode and convert, then the native resize: the fallback of
    ``load_image_u8`` when the runtime has no decoder."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img.convert(mode), np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[:2] != (dh, dw):
        arr = lib.resize_batch(arr[None], dh, dw, nthreads=1)[0]
    return arr


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_decode_exact(decode_lib, jlib, tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(3)
    p = str(tmp_path / "img.jpg")
    Image.fromarray(rng.integers(0, 256, (96, 80, 3), np.uint8)).save(
        p, quality=90)
    data = open(p, "rb").read()
    for dh, dw in [(96, 80), (64, 64), (256, 256)]:  # native size, resized
        got = decode_lib.decode_image(data, mode, dh, dw)
        np.testing.assert_array_equal(got, _pil_chain(p, mode, dh, dw,
                                                      decode_lib))
        np.testing.assert_array_equal(got, jlib.decode_image(data, mode, dh,
                                                             dw))


@pytest.mark.parametrize("pil_mode,mode", [("RGB", "RGB"), ("L", "L"),
                                           ("L", "RGB"), ("RGBA", "RGB"),
                                           ("P", "RGB")])
def test_png_decode_exact(decode_lib, jlib, tmp_path, pil_mode, mode):
    from PIL import Image

    rng = np.random.default_rng(4)
    if pil_mode == "L":
        src = Image.fromarray(rng.integers(0, 256, (50, 40), np.uint8), "L")
    elif pil_mode == "RGBA":
        src = Image.fromarray(rng.integers(0, 256, (50, 40, 4), np.uint8),
                              "RGBA")
    elif pil_mode == "P":
        src = Image.fromarray(
            rng.integers(0, 256, (50, 40, 3), np.uint8)).quantize(64)
    else:
        src = Image.fromarray(rng.integers(0, 256, (50, 40, 3), np.uint8))
    p = str(tmp_path / "img.png")
    src.save(p)
    data = open(p, "rb").read()
    got = decode_lib.decode_image(data, mode, 32, 32)
    np.testing.assert_array_equal(got, _pil_chain(p, mode, 32, 32,
                                                  decode_lib))
    np.testing.assert_array_equal(got, jlib.decode_image(data, mode, 32, 32))


def test_garbage_and_unsupported_return_none(decode_lib):
    assert decode_lib.decode_image(b"not an image", "RGB", 8, 8) is None
    assert decode_lib.decode_image(b"\xff\xd8\xff garbage", "RGB", 8,
                                   8) is None
    assert decode_lib.decode_image(b"x", "CMYK", 8, 8) is None


class _NoDecode:
    """The runtime as a build without libjpeg / libpng presents it."""
    has_decode = False

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, k):
        return getattr(self._lib, k)


@pytest.mark.parametrize("path_kind", ["native", "no_decode", "no_lib"])
def test_load_image_u8_equals_jax(decode_lib, jlib, tmp_path, monkeypatch,
                                  path_kind):
    """``load_image_u8`` dispatches as the JAX package's does, so each of
    its three paths (native decode and resize; PIL decode, native resize;
    PIL alone) gives the JAX package's bytes on the same files, JPEG and
    PNG, RGB and L, resized and not; the native path's bytes are the
    no-decoder path's."""
    from PIL import Image

    rng = np.random.default_rng(5)
    files = []
    for ext, shape in (("jpg", (70, 66, 3)), ("png", (40, 50, 3)),
                       ("png", (32, 32, 3))):
        p = str(tmp_path / f"s{len(files)}.{ext}")
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(p)
        files.append(p)
    swap = {"native": (decode_lib, jlib),
            "no_decode": (_NoDecode(decode_lib), _NoDecode(jlib)),
            "no_lib": (None, None)}[path_kind]
    native_out = {(p, m): T.load_image_u8(p, m, (32, 32))
                  for p in files for m in ("RGB", "L")}
    monkeypatch.setattr(T, "_native_lib", lambda: swap[0])
    monkeypatch.setattr(JT, "_native_lib", lambda: swap[1])
    for p in files:
        for m in ("RGB", "L"):
            got = T.load_image_u8(p, m, (32, 32))
            assert got.shape == (32, 32, 3 if m == "RGB" else 1)
            np.testing.assert_array_equal(got, JT.load_image_u8(p, m,
                                                                (32, 32)))
            if path_kind != "no_lib":
                np.testing.assert_array_equal(got, native_out[p, m])


def test_missing_file_still_raises(lib, tmp_path):
    with pytest.raises(OSError):
        T.load_image_u8(str(tmp_path / "nope.jpg"), "RGB", (8, 8))
