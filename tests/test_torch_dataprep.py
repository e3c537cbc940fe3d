"""The port's data preparation (dataprep/, pipelines/preprocessing.py, the
``data-prep`` CLI) against the JAX package's on the same inputs, mirroring
tests/test_dataprep.py, test_geotiff_fuzz.py, test_qa.py and
test_etl_pipeline.py:

* geodesy equal to the last bit; telemetry parsing equal;
* GeoTIFFs written by either package's writer (and by PIL's libtiff for
  LZW and PackBits) read by the other, array-equal for every layout and
  codec, plus a hypothesis fuzz with few examples;
* ``extract_grid_patch`` equal;
* the optical preprocessing's ``coords.csv`` byte-equal to JAX's pandas
  output, its images pixel-equal (AverageSubtraction and CLAHE);
* combine pixel-equal to JAX's cv2 path, within 1 LSB where it resizes
  (cv2 rounds its bilinear weights to 11-bit fixed point);
* the QA report equal;
* ``run_auv_preprocessing`` end to end: the same tree file for file, CSVs
  byte-equal, PNGs and JPEGs pixel-equal.
"""
import csv
import os
import shutil
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from multimodal_auv_torch.dataprep import combine as TC
from multimodal_auv_torch.dataprep import exif as TE
from multimodal_auv_torch.dataprep import geodesy as TG
from multimodal_auv_torch.dataprep import geotiff as TT
from multimodal_auv_torch.dataprep import optical as TO
from multimodal_auv_torch.dataprep import qa as TQ
from multimodal_auv_torch.dataprep import utilities as TUt
from multimodal_auv_torch.pipelines.preprocessing import (
    run_auv_preprocessing as t_prep,
)
from multimodal_auv_tpu.dataprep import exif as JE
from multimodal_auv_tpu.dataprep import geodesy as JG
from multimodal_auv_tpu.dataprep import geotiff as JT
from multimodal_auv_tpu.dataprep import optical as JO
from multimodal_auv_tpu.dataprep import qa as JQ
from multimodal_auv_tpu.dataprep import utilities as JUt
from multimodal_auv_tpu.pipelines.preprocessing import (
    run_auv_preprocessing as j_prep,
)
from tests.fixtures.make_tree import make_inference_tree, make_training_tree
from tests.test_etl_pipeline import _COMMENT, _make_raw_tree

TR = (500000.0, 0.5, 0.0, 6000000.0, 0.0, -0.5)


def test_geodesy_bit_equal():
    rng = np.random.default_rng(0)
    lats = np.concatenate([rng.uniform(-80, 84, 300), [0.0, -33.92, 51.2]])
    lons = np.concatenate([rng.uniform(-180, 179.99, 300), [-180.0, 18.42,
                                                             7.5]])
    for lat, lon in zip(lats.tolist(), lons.tolist()):
        assert TG.latlon_to_utm(lat, lon) == JG.latlon_to_utm(lat, lon)
        assert TG.utm_zone(lon) == JG.utm_zone(lon)
    for v, h in ((5530.123, "N"), (617.5, "W"), ("5530.123", "S"),
                 (0.0, "E")):
        assert TG.ddmm_to_decimal(v, h) == JG.ddmm_to_decimal(v, h)


@pytest.mark.parametrize("comment", [
    _COMMENT,
    _COMMENT.replace("5530.000N", "3355.200S").replace("00530.000W",
                                                      "01825.200E"),
    "<lat>bad</lat><lon>00530.000W</lon><depth>x</depth>",
    "<altitude>1.5</altitude>",
    "",
])
def test_telemetry_parsing_equal(comment):
    got, want = TE.parse_telemetry(comment), JE.parse_telemetry(comment)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] == want[k]) or (np.isnan(got[k]) and np.isnan(want[k]))


def test_jpeg_comment_reader_equal(tmp_path):
    root = _make_raw_tree(str(tmp_path / "raw"), n=2)
    paths = sorted(os.path.join(root, "dive1", f)
                   for f in os.listdir(os.path.join(root, "dive1")))
    plain = str(tmp_path / "plain.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(plain)
    for p in paths + [plain, str(tmp_path / "missing.jpg")]:
        assert TE.read_jpeg_comment(p) == JE.read_jpeg_comment(p)
    # no exiftool on either machine: both fall back to the COM reader
    assert TE.get_comments(paths, "no-such-exiftool") == JE.get_comments(
        paths, "no-such-exiftool")


# (writer kwargs, dtype, bands): every layout and codec both writers share
LAYOUTS = [
    (dict(), np.uint8, 1),
    (dict(compression="deflate"), np.uint8, 2),
    (dict(rows_per_strip=7), np.uint16, 3),
    (dict(tile=(16, 16), compression="deflate"), np.uint8, 2),
    (dict(planar=2, rows_per_strip=5), np.float32, 2),
    (dict(planar=2, tile=(16, 32), compression="deflate"), np.int16, 3),
    (dict(predictor=2, compression="deflate"), np.uint16, 1),
    (dict(predictor=2, rows_per_strip=9), np.int16, 2),
    (dict(predictor=3, compression="deflate"), np.float32, 2),
    (dict(predictor=3, planar=2, tile=(16, 16)), np.float64, 2),
    (dict(bigtiff=True, compression="deflate"), np.float32, 1),
    (dict(transform_matrix=True, nodata=-9999.0), np.float32, 1),
    (dict(compression="zstd", rows_per_strip=10), np.uint8, 2),
]


def _raster(dtype, bands, h=37, w=45, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1000, (h, w, bands))
    if np.dtype(dtype).kind in "ui":
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, (h, w, bands), endpoint=True)
    return np.squeeze(a.astype(dtype), -1) if bands == 1 else a.astype(dtype)


def _read_all(mod, path):
    g = mod.GeoTiff.open(path)
    return np.stack([g.read(b) for b in range(g.count)], -1), g


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
def test_geotiff_cross_package_equal(tmp_path, case):
    kw, dtype, bands = LAYOUTS[case]
    data = _raster(dtype, bands, seed=case)
    full = data if data.ndim == 3 else data[:, :, None]
    for writer, reader, tag in ((JT, TT, "j2t"), (TT, JT, "t2j")):
        p = str(tmp_path / f"{tag}.tif")
        writer.write_geotiff(p, data, TR, **kw)
        got, g = _read_all(reader, p)
        want, gw = _read_all(writer, p)
        np.testing.assert_array_equal(got, full)
        np.testing.assert_array_equal(got, want)
        assert (g.res, g.bounds, g.nodata) == (gw.res, gw.bounds, gw.nodata)
    assert open(str(tmp_path / "j2t.tif"), "rb").read() == \
        open(str(tmp_path / "t2j.tif"), "rb").read()  # the same writer


@pytest.mark.parametrize("pil_codec",
                         ["tiff_lzw", "packbits", "tiff_adobe_deflate"])
def test_geotiff_libtiff_codecs_read_equal(tmp_path, pil_codec):
    """LZW (the 9 -> 12 bit widths) and PackBits rasters written by
    libtiff through PIL: both readers decode the same pixels."""
    arr = (np.arange(200 * 300, dtype=np.uint32) % 251).astype(
        np.uint8).reshape(200, 300)
    arr[50:90] = np.random.default_rng(0).integers(0, 256, (40, 300))
    p = str(tmp_path / "lib.tif")
    Image.fromarray(arr).save(p, compression=pil_codec)
    got = TT.GeoTiff.open(p).read()
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, JT.GeoTiff.open(p).read())


def test_lzw_writer_read_by_jax_and_libtiff(tmp_path):
    """The port's LZW writer (an addition: JAX's writer has none) against
    JAX's decoder and libtiff's, and its codes against tests/lzw_ref.py."""
    from tests.lzw_ref import lzw_encode

    rng = np.random.default_rng(1)
    for payload in (b"", b"\x07", bytes(rng.integers(0, 4, 9000,
                                                     dtype=np.uint8)),
                    bytes(rng.integers(0, 256, 20000, dtype=np.uint8))):
        assert TT._lzw_encode(payload) == lzw_encode(payload)
        assert JT._lzw_decode(TT._lzw_encode(payload), len(payload)) == \
            payload
    data = _raster(np.uint8, 2, h=120, w=90)
    p = str(tmp_path / "lzw.tif")
    TT.write_geotiff(p, data, TR, compression="lzw", predictor=2,
                     rows_per_strip=32)
    np.testing.assert_array_equal(_read_all(JT, p)[0], data)
    np.testing.assert_array_equal(_read_all(TT, p)[0], data)
    p1 = str(tmp_path / "lzw1.tif")
    TT.write_geotiff(p1, data[:, :, 0], TR, compression="lzw")
    np.testing.assert_array_equal(np.asarray(Image.open(p1)), data[:, :, 0])


@settings(max_examples=15, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 40), w=st.integers(1, 40), bands=st.integers(1, 3),
       dtype=st.sampled_from([np.uint8, np.int16, np.uint16, np.float32]),
       planar=st.sampled_from([1, 2]), tiled=st.booleans(),
       comp=st.sampled_from(["none", "deflate"]), seed=st.integers(0, 99))
def test_geotiff_fuzz_cross_package(tmp_path, h, w, bands, dtype, planar,
                                    tiled, comp, seed):
    data = _raster(dtype, bands, h=h, w=w, seed=seed)
    kw = dict(planar=planar, compression=comp)
    kw.update(tile=(16, 16)) if tiled else kw.update(
        rows_per_strip=max(1, h // 3))
    p = str(tmp_path / f"f{seed}_{h}_{w}.tif")
    TT.write_geotiff(p, data, TR, **kw)
    np.testing.assert_array_equal(_read_all(JT, p)[0], _read_all(TT, p)[0])
    JT.write_geotiff(p, data, TR, **kw)
    np.testing.assert_array_equal(_read_all(TT, p)[0], _read_all(JT, p)[0])


def test_corrupt_rasters_fail_alike(tmp_path):
    """tests/test_geotiff_fuzz.py's truncations: the port's reader raises
    where JAX's does and returns the same array where it reads."""
    p = str(tmp_path / "v.tif")
    TT.write_geotiff(p, _raster(np.uint8, 1, 40, 56), TR)
    blob = open(p, "rb").read()
    for frac in (0.01, 0.1, 0.5, 0.9, 0.99):
        q = str(tmp_path / f"t{frac}.tif")
        open(q, "wb").write(blob[:max(1, int(len(blob) * frac))])
        outs = []
        for mod in (JT, TT):
            try:
                outs.append(mod.GeoTiff.open(q).read())
            except (mod.TiffError, ValueError, NotImplementedError) as e:
                outs.append(type(e).__name__)
        if isinstance(outs[0], str):
            assert outs[1] == outs[0]
        else:
            np.testing.assert_array_equal(outs[1], outs[0])


def test_extract_grid_patch_equal(tmp_path):
    data = _raster(np.uint8, 2, h=200, w=200)
    p = str(tmp_path / "site_a_b_Bathy.tif")
    TT.write_geotiff(p, data, TR, compression="deflate")
    rng = np.random.default_rng(2)
    points = [(500050.0, 5999950.0), (500000.0, 6000000.0),
              (499990.0, 5999990.0), (600000.0, 5000000.0)]
    points += [(500000 + rng.uniform(0, 100), 6000000 - rng.uniform(0, 100))
               for _ in range(20)]
    for (e, n), win in zip(points, [20.0, 30.0, 10.0, 5.0] * 6):
        got = TT.extract_grid_patch(p, e, n, win)
        want = JT.extract_grid_patch(p, e, n, win)
        assert got[1:] == want[1:]
        if want[0] is None:
            assert got[0] is None
        else:
            np.testing.assert_array_equal(got[0], want[0])
    assert TT.get_pixel_resolution(p) == JT.get_pixel_resolution(p)


@pytest.mark.parametrize("method", ["AverageSubtraction", "CLAHE"])
def test_optical_preprocessing_equal(tmp_path, method):
    """coords.csv byte-equal to JAX's pandas ``to_csv`` (floats, the
    negated depth, empty telemetry fields, NaN eastings of a frame without
    coordinates), the processed frames and folder averages pixel-equal."""
    raw = _make_raw_tree(str(tmp_path / "raw"), n=3)
    Image.fromarray(np.full((64, 64, 3), 70, np.uint8)).save(
        os.path.join(raw, "dive1", "frame_9999.jpg"),
        comment=b"<altitude>3.25</altitude><depth>0.0</depth>")
    out = str(tmp_path / "out")
    outputs = {}
    for name, mod in (("jax", JO), ("torch", TO)):
        rows = mod.preprocess_optical_images(raw, out, method)
        outputs[name] = {f: open(os.path.join(out, f), "rb").read()
                         for f in sorted(os.listdir(out)) if f.endswith(
                             ".csv")}
        outputs[name]["_images"] = {
            f: np.asarray(Image.open(os.path.join(out, f)))
            for f in sorted(os.listdir(out)) if not f.endswith(".csv")}
        outputs[name]["_n"] = len(rows)
        shutil.rmtree(out)
    j, t = outputs["jax"], outputs["torch"]
    assert t["coords.csv"] == j["coords.csv"]
    assert t["_n"] == j["_n"] == 4
    assert t["_images"].keys() == j["_images"].keys()
    for f in j["_images"]:
        np.testing.assert_array_equal(t["_images"][f], j["_images"][f])
    assert b"frame_9999.jpg" in t["coords.csv"] and b",-0.0," in \
        t["coords.csv"]


def test_coords_csv_no_frames_equal(tmp_path):
    """An empty survey: pandas writes one empty line; so does the port."""
    os.makedirs(tmp_path / "raw")
    for name, mod in (("jax", JO), ("torch", TO)):
        out = str(tmp_path / name)
        assert len(mod.preprocess_optical_images(str(tmp_path / "raw"),
                                                 out)) == 0
    assert open(tmp_path / "torch" / "coords.csv", "rb").read() == open(
        tmp_path / "jax" / "coords.csv", "rb").read() == b"\n"


def test_clahe_numpy_paths_equal():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TO.equalize_adapthist_rgb(img),
                                  JO.equalize_adapthist_rgb(img))
    np.testing.assert_array_equal(TO.clahe_u8(img[:, :, 0], 0.02, (16, 16)),
                                  JO.clahe_u8(img[:, :, 0], 0.02, (16, 16)))
    assert TO.rescale_intensity_uint8(img - 100.5).tolist() == \
        JO.rescale_intensity_uint8(img - 100.5).tolist()


def _channel_tree(root, shapes, seed=0, rgb_second=False):
    """Sample folders with output_channel_1/2 of the given shapes (a
    stale ``demeaned`` file too, which both delete)."""
    rng = np.random.default_rng(seed)
    for i, (s1, s2) in enumerate(shapes):
        d = os.path.join(root, f"s{i}")
        os.makedirs(d)
        Image.fromarray(rng.integers(0, 256, s1, dtype=np.uint8)).save(
            os.path.join(d, "output_channel_1.png"))
        s2 = s2 + (3,) if rgb_second else s2
        Image.fromarray(rng.integers(0, 256, s2, dtype=np.uint8)).save(
            os.path.join(d, "output_channel_2.png"))
        open(os.path.join(d, "x_demeaned.png"), "wb").write(b"x")
    return root


@pytest.mark.parametrize("shapes,rgb_second,max_lsb", [
    ([((40, 40), (40, 40)), ((13, 57), (13, 57))], False, 0),
    ([((40, 40), (40, 40))], True, 0),
    ([((40, 40), (20, 20)), ((40, 40), (80, 80)), ((37, 53), (40, 40)),
      ((40, 41), (7, 9))], False, 1),
])
def test_combine_matches_cv2(tmp_path, shapes, rgb_second, max_lsb):
    """Pixel-equal to JAX's cv2 read / write where nothing is resized
    (a colour second channel too: libpng's rgb_to_gray); at most 1 LSB
    where it resizes."""
    outs = {}
    for name, mod in (("jax", sys.modules["multimodal_auv_tpu.dataprep"
                                          ".combine"]), ("torch", TC)):
        root = _channel_tree(str(tmp_path / name), shapes,
                             rgb_second=rgb_second)
        assert mod.process_frame_channels_in_subfolders(root) == len(shapes)
        outs[name] = {d: np.asarray(Image.open(os.path.join(
            root, d, "combined_channels.png"))).astype(int)
            for d in sorted(os.listdir(root))}
        for d in outs[name]:
            assert not os.path.exists(os.path.join(root, d, "x_demeaned.png"))
    for d in outs["jax"]:
        diff = np.abs(outs["torch"][d] - outs["jax"][d])
        assert outs["torch"][d].shape == outs["jax"][d].shape
        assert diff.max() <= max_lsb, (d, diff.max())
        assert (outs["torch"][d][:, :, 0] == 0).all()


def test_read_gray_matches_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
    cases = {"rgb.png": Image.fromarray(rgb), "rgba.png": Image.fromarray(
        rgba), "pal.png": Image.fromarray(rgb).convert("P"),
        "gray.png": Image.fromarray(rgb[:, :, 0]), "rgb.jpg":
        Image.fromarray(rgb), "rgb.bmp": Image.fromarray(rgb)}
    for name, img in cases.items():
        p = str(tmp_path / name)
        img.save(p)
        np.testing.assert_array_equal(TC.read_gray_u8(p),
                                      cv2.imread(p, cv2.IMREAD_GRAYSCALE))


def _break_tree(root):
    from tests.test_qa import _break_tree as jax_break

    jax_break(root)


@pytest.mark.parametrize("kind", ["training", "inference"])
def test_qa_report_equal(tmp_path, kind):
    if kind == "training":
        root = make_training_tree(str(tmp_path / "t"), n_samples=9)
        _break_tree(root)
    else:
        root = make_inference_tree(str(tmp_path / "i"), n_samples=5)
        s = sorted(os.listdir(root))
        for f in os.listdir(os.path.join(root, s[0])):
            if "bathy" in f:
                os.remove(os.path.join(root, s[0], f))
    for deep in (False, True):
        got = TQ.survey_tree_report(root, kind=kind, deep=deep)
        want = JQ.survey_tree_report(root, kind=kind, deep=deep)
        assert [vars(f) for f in got.folders] == [vars(f) for f in
                                                   want.folders]
        assert got.summary_lines() == want.summary_lines()
        assert got.problem_histogram() == want.problem_histogram()
    with pytest.raises(ValueError):
        TQ.survey_tree_report(root, kind="other")


def test_data_check_cli_equal(tmp_path, capsys):
    root = make_training_tree(str(tmp_path / "c"), n_samples=3)
    assert TQ.data_check_cli(["--root_dir", root]) == 0
    capsys.readouterr()
    os.remove(os.path.join(root, sorted(os.listdir(root))[0], "Sand.txt"))
    outs = []
    for mod in (JQ, TQ):
        rc = mod.data_check_cli(["--root_dir", root, "--show_ok"])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[1][0] == 1
    assert "missing-label" in outs[1][1] and "2/3" in outs[1][1]


def test_utilities_equal(tmp_path):
    assert TUt.is_geotiff("a.TIF") and TUt.is_geotiff("b.tiff")
    assert not TUt.is_geotiff("c.gtiff") and not TUt.is_geotiff("d.png")
    assert TUt.filter_csv_by_image_names("/nonexistent/c.csv", "/x") == []
    p = tmp_path / "coords.csv"
    with open(p, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(
            [["Image_Name", "path", "depth"], ["a.jpg", "/a/x.jpg", "-3.5"],
             ["b.jpg", "/a/y.jpg", "-4.0"], ["c.jpg", "/b/c.jpg", "-1.25"]])
    (tmp_path / "imgs").mkdir()
    for n in ("a.jpg", "c.jpg"):
        (tmp_path / "imgs" / n).write_bytes(b"")
    got = TUt.filter_csv_by_image_names(str(p), str(tmp_path / "imgs"))
    want = JUt.filter_csv_by_image_names(str(p), str(tmp_path / "imgs"))
    assert [r["Image_Name"] for r in got] == list(want["Image_Name"])
    assert [r["Image_Name"] for r in TUt.filter_csv_by_image_names(
        str(p), str(tmp_path / "none"))] == []
    j = tmp_path / "j.csv"
    shutil.copy(p, j)
    rows = TUt.update_csv_path(str(p), "/a", "/z")
    JUt.update_csv_path(str(j), "/a", "/z")
    assert [r["path"] for r in rows] == ["/z/x.jpg", "/z/y.jpg", "/b/c.jpg"]
    assert open(p, "rb").read() == open(j, "rb").read()
    assert TUt.update_csv_path(str(tmp_path / "nope.csv"), "/a", "/b") is None
    q = tmp_path / "other.csv"
    q.write_text("other\n1\n2\n")
    assert [r["other"] for r in TUt.filter_csv_by_image_names(
        str(q), str(tmp_path))] == ["1", "2"]
    assert TUt.update_csv_path(str(q), "/a", "/b") is None


def _write_rasters(gdir, codecs=("none", "none")):
    e, n, _, _ = TG.latlon_to_utm(55.5, -5.5)
    os.makedirs(gdir, exist_ok=True)
    tr = (e - 50.0, 0.5, 0.0, n + 50.0, 0.0, -0.5)
    rng = np.random.default_rng(1)
    TT.write_geotiff(os.path.join(gdir, "site_a_b_Bathy.tif"),
                     rng.integers(0, 256, (200, 200, 2)).astype(np.uint8),
                     tr, compression=codecs[0])
    TT.write_geotiff(os.path.join(gdir, "site_a_b_SSS.tif"),
                     rng.integers(0, 256, (200, 200)).astype(np.uint8), tr,
                     compression=codecs[1])
    return gdir


def _tree_files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("method,codecs", [
    ("AverageSubtraction", ("lzw", "deflate")), ("CLAHE", ("none", "none"))])
def test_run_auv_preprocessing_equal(tmp_path, method, codecs):
    """Both pipelines into the same output path in turn (coords.csv holds
    absolute paths): the same tree, CSVs and text byte-equal, images
    pixel-equal."""
    raw = _make_raw_tree(str(tmp_path / "raw"), n=3)
    gdir = _write_rasters(str(tmp_path / "tiffs"), codecs)
    out = str(tmp_path / "out")
    for name, fn in (("jax", j_prep), ("torch", t_prep)):
        samples = fn(raw, gdir, out, window_size_meters=20.0,
                     image_enhancement_method=method)
        assert samples == os.path.join(out, "samples")
        os.rename(out, str(tmp_path / name))
    files = _tree_files(str(tmp_path / "jax"))
    assert _tree_files(str(tmp_path / "torch")) == files
    # the QA report over each package's output: the same verdicts (both
    # name the combined bathy combined_channels.png, which the inference
    # scan does not take: "missing-bathy" in every folder)
    reps = [mod.survey_tree_report(str(tmp_path / n / "samples"),
                                   kind="inference")
            for mod, n in ((JQ, "jax"), (TQ, "torch"))]
    assert [(os.path.basename(f.folder), f.ok, f.problems)
            for f in reps[1].folders] == [
        (os.path.basename(f.folder), f.ok, f.problems)
        for f in reps[0].folders]
    assert reps[1].problem_histogram() == {"missing-bathy": 3}
    assert "samples/frame_0000/combined_channels.png" in files
    for rel in files:
        a, b = (str(tmp_path / n / rel) for n in ("jax", "torch"))
        if rel.endswith((".csv", ".txt")):
            assert open(a, "rb").read() == open(b, "rb").read(), rel
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)), rel)


def test_data_prep_cli_runs(tmp_path, capsys):
    """``python -m multimodal_auv_torch.cli data-prep`` with the JAX
    CLI's flags: exit 0 and the sample folders of
    tests/test_etl_pipeline.py, equal to the JAX CLI's."""
    from multimodal_auv_torch import cli
    from multimodal_auv_tpu import cli as jcli

    raw = _make_raw_tree(str(tmp_path / "raw"), n=3)
    gdir = _write_rasters(str(tmp_path / "tiffs"))
    out = str(tmp_path / "out")
    argv = ["--raw_optical_images_folder", raw, "--geotiff_folder", gdir,
            "--output_folder", out, "--window_size_meters", "20",
            "--image_enhancement_method", "CLAHE", "--skip_bathy_combine"]
    assert jcli.data_preparation_cli(argv) == 0
    os.rename(out, str(tmp_path / "jax"))
    assert cli.main(["data-prep"] + argv) == 0
    assert _tree_files(out) == _tree_files(str(tmp_path / "jax"))
    d0 = set(os.listdir(os.path.join(out, "samples", "frame_0000")))
    assert {"frame_0000.jpg", "row_data.csv", "unlabelled.txt",
            "output_channel_1.png", "output_channel_2.png",
            "grid_a_b_SSS.png"} <= d0
    assert "combined_channels.png" not in d0  # --skip_bathy_combine
    with pytest.raises(SystemExit):
        cli.main(["data-prep", "--raw_optical_images_folder", raw])
