"""The port's convert CLI (auromat_tpu_torch.cli.convert), its spacecraft
provider and exporters, against the JAX package's CLI on the CPU.

* ``convert --mosaic 0.25 --mosaic-extent 47 62 -112 -91`` on the
  two-frame folder of tests/test_cli.py (real 12 MP frames), both CLIs
  with bursts of 2, each file read back with the JAX package's reader:
  the same plate-carree grid and photo time; the two f32 georeference
  chains (ROADMAP.md F2) may move a cell in or out of the mosaic, so the
  masks may differ on < 1% of the cells and the uint8 image may differ by
  one step on < 1% of the cells both fill (a cell whose count differs by
  one); zenith angle within 0.05 deg there. The file's occupied cells
  equal those of ``mosaic_sequence`` on the same bursts.
* The JAX CLI's validation and early-skip cases, the premask and time
  stamp, ``iterParamBursts``'s uint8 refusal.
* The per-frame path (``--grid geo --min-elevation 10 --format cdf``) on a
  scaled copy of the real frame against the JAX CLI's file: float64 on
  both sides, so grids within 1e-9 deg, masks and uint8 image equal; and
  the same folder with ``--grid mag`` (the MLat/MLT grid) against the JAX
  CLI, with the same tolerances; and the frame as an ESA ISS archive cache
  (``--grid geo``, CDF and netCDF, the netCDF read back by the port's
  reader) against the JAX CLI, with the same tolerances.
* ``cli.download``'s argument parsing, against the JAX CLI's parser.
* ``--platform cuda`` without a CUDA device exits nonzero, and so does no
  ``--platform`` (cuda is the default; the tests pass ``--platform cpu``);
  the port's CLI, parallel and export modules import no jax.
"""

import datetime as dt
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from auromat_tpu.cli import convert as jconvert
from auromat_tpu.io import fits as jfits
from auromat_tpu.mapping.cdf import read_mapping as jread_cdf
from auromat_tpu.mapping.netcdf import read_mapping as jread_nc
from auromat_tpu_torch.mapping.netcdf import read_mapping as read_nc
from auromat_tpu_torch import parallel
from auromat_tpu_torch.cli import convert
from auromat_tpu_torch.mapping import spacecraft as sc
from auromat_tpu_torch.ops.regrid import fixed_grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
FRAME = "ISS030-E-102170_dc"
MOSAIC = ["--mosaic", "0.25", "--mosaic-extent", "47", "62", "-112", "-91"]
CPU = ["--platform", "cpu"]  # the port's CLI computes on the card by default


def assert_close_defined(a, b, tol=1e-9):
    ok = ~np.isnan(a) & ~np.isnan(b)
    assert ok.sum() > 100 and np.abs(a[ok] - b[ok]).max() < tol


def run_port(*args, env=None):
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def folder2(tmp_path_factory):
    """Two same-shaped frames (the second a renamed copy), as in
    tests/test_cli.py::spacecraft_folder2."""
    d = tmp_path_factory.mktemp("mosaic") / "data2"
    d.mkdir()
    for name in (FRAME, "ISS030-E-102171_dc"):
        shutil.copy(os.path.join(RES, f"{FRAME}.jpg"), d / f"{name}.jpg")
        shutil.copy(os.path.join(RES, f"{FRAME}.wcs"), d / f"{name}.wcs")
    return str(d)


@pytest.fixture(scope="module")
def mosaic_files(folder2, tmp_path_factory):
    out = tmp_path_factory.mktemp("mosaic_out")
    args = [folder2, *MOSAIC, "--format", "netcdf", "--batched", "2"]
    assert jconvert.main(args + ["--out", str(out / "jax")]) == 0
    assert convert.main(CPU + args + ["--out", str(out / "port")]) == 0
    return [str(out / side / "data2.mosaic.nc") for side in ("port", "jax")]


def test_convert_mosaic_matches_jax_cli(folder2, mosaic_files):
    m, jm = (jread_nc(p) for p in mosaic_files)
    m.checkPlateCarree()
    m.checkGuarantees()
    assert m.img.shape == jm.img.shape == (59, 83, 3)
    assert np.array_equal(m.lats.data, jm.lats.data)
    assert np.array_equal(m.lons.data, jm.lons.data)
    assert m.photoTime == jm.photoTime and m.altitude == jm.altitude
    for ours, theirs in ((m.mLatMlt, jm.mLatMlt),
                         (m.mLatMltCenter, jm.mLatMltCenter)):
        for a, b in zip(ours, theirs):
            assert_close_defined(a.data, b.data)
    occ, jocc = ~m.center_mask, ~jm.center_mask
    assert occ.sum() > 2000
    assert (occ != jocc).mean() < 1e-2
    both = occ & jocc
    d = np.abs(m.img.data.astype(int) - jm.img.data.astype(int))[both]
    assert (d > 1).mean() < 1e-2 and (d != 0).mean() < 1e-2
    e = np.abs(m.elevation.data - jm.elevation.data)[both]
    assert (e > 0.05).mean() < 1e-2

    # the file's occupied cells are the mosaic's
    prov = sc.SpacecraftMappingProvider(folder2, device="cpu")
    grid = fixed_grid(4.0, 47.0, 62.0, -112.0, -91.0)
    count, _ = parallel.mosaic_sequence(
        parallel.make_mesh(sp=1, device="cpu"), grid, prov.iterParamBursts(batch=2),
        batch=2)
    assert np.array_equal(occ, count[:grid.n_lat].numpy() > 0)


def test_convert_mosaic_skip_and_refusals(folder2, mosaic_files, tmp_path):
    out = os.path.dirname(mosaic_files[0])
    args = [folder2, *MOSAIC, "--format", "netcdf", "--out", out]
    assert convert.main(CPU + args) == 0  # exists: skipped
    parsed = convert.build_parser().parse_args([folder2, "--mosaic", "0.25"])
    assert convert.convert_mosaic(object(), parsed, out, "cpu") is None


def test_convert_mosaic_validation_and_early_skip(folder2, tmp_path):
    out = tmp_path / "outv"
    out.mkdir()
    for extra in (
        ["--mosaic", "0"],
        ["--mosaic", "0.25", "--mosaic-extent", "-10", "10", "170", "-170"],
        ["--mosaic", "0.25", "--mosaic-extent", "62", "47", "-112", "-91"],
    ):
        assert convert.main(CPU + [folder2, *extra, "--format", "netcdf",
                             "--out", str(out)]) == 1
    target = out / "data2.mosaic.nc"
    target.write_bytes(b"")

    class Explosive:
        iterParamBursts = None  # satisfies the capability probe

        def __getattr__(self, name):
            raise AssertionError(f"provider touched: {name}")

    args = convert.build_parser().parse_args(
        [folder2, "--mosaic", "0.25", "--format", "netcdf", "--out", str(out)])
    assert convert.convert_mosaic(Explosive(), args, str(out),
                                  "cpu") == str(target)
    # argument validation still comes first
    assert convert.main(CPU + [folder2, "--mosaic", "0", "--format", "netcdf",
                         "--out", str(out)]) == 1


def test_iter_param_bursts_refuses_non_uint8(folder2, monkeypatch):
    real_load = sc.load_image
    monkeypatch.setattr(sc, "load_image",
                        lambda p: real_load(p).astype(np.uint16) * 257)
    prov = sc.SpacecraftMappingProvider(folder2, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        next(prov.iterParamBursts(batch=2))


def test_convert_mosaic_premask_and_time_stamp(folder2, tmp_path,
                                               monkeypatch):
    prov = sc.SpacecraftMappingProvider(folder2, device="cpu")
    t0, t1 = prov.timeRange()
    assert t0 is not None and t1 >= t0 and prov.range == (t0, t1)
    after = t1 + dt.timedelta(seconds=1)
    assert prov.timeRange(after, None) == (None, None)
    assert prov.timeRange(None, after) == (t0, t1)
    assert prov.contains(t0) and not prov.contains(after + dt.timedelta(1))
    seen = {}

    def fake_mosaic_sequence(mesh, grid, bursts, batch=8,
                             bin_method="pallas", min_elevation=None, **kw):
        seen["min_elevation"] = min_elevation
        seen["bin_method"] = bin_method
        count = torch.zeros((grid.n_lat, grid.n_lon))
        means = torch.full((grid.n_lat, grid.n_lon, 4), torch.nan)
        count[0, 0] = 1.0
        means[0, 0] = torch.tensor((10.0, 20.0, 30.0, 45.0))
        return count, means

    monkeypatch.setattr(parallel, "mosaic_sequence", fake_mosaic_sequence)
    out = tmp_path / "outp"
    assert convert.main(CPU + [folder2, *MOSAIC, "--min-elevation", "10",
                         "--format", "cdf", "--out", str(out)]) == 0
    assert seen == {"min_elevation": 10.0, "bin_method": "pallas"}
    m = jread_cdf(str(out / "data2.mosaic.cdf"))
    assert abs((m.photoTime - t0).total_seconds()) < 1.0
    assert (~m.center_mask).sum() == 1
    assert tuple(m.img.data[0, 0]) == (10, 20, 30)
    (tmp_path / "outp2").mkdir()
    args = convert.build_parser().parse_args(
        [folder2, "--mosaic", "0.25",
         "--start", after.strftime("%Y-%m-%dT%H:%M:%S"),
         "--format", "cdf", "--out", str(tmp_path / "outp2")])
    assert convert.convert_mosaic(prov, args, str(tmp_path / "outp2"),
                                  "cpu") is None


ISS_KEY = "ISS030-E-102170"


def make_iss_cache(small_folder, folder):
    """An offline ESA ISS archive cache around the small frame."""
    import json

    os.makedirs(folder)
    shutil.copy(os.path.join(small_folder, "small.png"),
                os.path.join(folder, f"{ISS_KEY}.png"))
    shutil.copy(os.path.join(small_folder, "small.wcs"),
                os.path.join(folder, f"{ISS_KEY}.wcs"))
    date = "2012-01-25T09:27:08.060000"
    api = {"id": 77, "date_start": date, "date_end": date,
           "image_extension": ".png", "metadata_uri": "unused",
           "images": {ISS_KEY: {"date": date, "image_uri": "unused",
                                "wcs_uri": "unused"}}}
    with open(os.path.join(folder, "api.json"), "w") as f:
        json.dump(api, f)
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump({"sequence_metadata": {"Project": "THOR"}}, f)
    return str(folder)


@pytest.fixture(scope="module")
def small_folder(tmp_path_factory):
    """The real frame's calibration scaled to 512x384 pixels, with a seeded
    PNG image: the per-frame path at a small size."""
    from PIL import Image

    d = tmp_path_factory.mktemp("small") / "small"
    d.mkdir()
    hd = jfits.read_header(os.path.join(RES, f"{FRAME}.wcs"))
    scale = hd["IMAGEW"] / 512
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        hd[k] = hd[k] * scale
    hd["CRPIX1"], hd["CRPIX2"] = hd["CRPIX1"] / scale, hd["CRPIX2"] / scale
    hd["IMAGEW"], hd["IMAGEH"] = 512, 384
    jfits.write_header(hd, str(d / "small.wcs"))
    img = np.random.default_rng(5).integers(0, 256, (384, 512, 3), np.uint8)
    Image.fromarray(img).save(d / "small.png")
    return str(d)


def test_convert_per_frame_cdf_matches_jax_cli(small_folder, tmp_path):
    args = [small_folder, "--grid", "geo", "--arcsecperpx", "900",
            "--min-elevation", "10", "--format", "cdf"]
    assert jconvert.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert convert.main(CPU + args + ["--out", str(tmp_path / "port")]) == 0
    m, jm = (jread_cdf(str(tmp_path / side / "small.cdf"))
             for side in ("port", "jax"))
    m.checkPlateCarree()
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        a, b = getattr(m, name).data, getattr(jm, name).data
        assert a.shape == b.shape and np.abs(a - b).max() < 1e-9
    assert np.array_equal(m.center_mask, jm.center_mask)
    assert (~m.center_mask).sum() > 300
    assert np.array_equal(m.img.filled(0), jm.img.filled(0))
    ok = ~m.center_mask
    assert np.abs(m.elevation.data - jm.elevation.data)[ok].max() < 1e-6
    assert (m.elevation.data[ok] >= 10 - 1e-6).all()
    for ours, theirs in ((m.mLatMlt, jm.mLatMlt),
                         (m.mLatMltCenter, jm.mLatMltCenter)):
        for a, b in zip(ours, theirs):
            assert_close_defined(a.data, b.data)
    # skip-existing
    assert convert.main(CPU + args + ["--out", str(tmp_path / "port")]) == 0
    # the magnetic (MLat/MLT) grid against the JAX CLI: float64 on both
    # sides, so grids within 1e-9 deg, masks and uint8 image equal
    mag = [small_folder, "--grid", "mag", "--arcsecperpx", "900",
           "--format", "cdf"]
    assert jconvert.main(mag + ["--out", str(tmp_path / "jmag")]) == 0
    assert convert.main(CPU + mag + ["--out", str(tmp_path / "mag")]) == 0
    m, jm = (jread_cdf(str(tmp_path / side / "small.cdf"))
             for side in ("mag", "jmag"))
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        a, b = getattr(m, name).data, getattr(jm, name).data
        assert a.shape == b.shape and np.abs(a - b).max() < 1e-9
    assert np.array_equal(m.center_mask, jm.center_mask)
    assert (~m.center_mask).sum() > 300
    assert np.array_equal(m.img.filled(0), jm.img.filled(0))
    ok = ~m.center_mask
    assert np.abs(m.elevation.data - jm.elevation.data)[ok].max() < 1e-6
    for ours, theirs in ((m.mLatMlt, jm.mLatMlt),
                         (m.mLatMltCenter, jm.mLatMltCenter)):
        for a, b in zip(ours, theirs):
            assert_close_defined(a.data, b.data)
    # the regular grid is the magnetic one: MLat is constant along a row
    mlat = m.mLatMltCenter[0].data
    assert np.nanmax(np.ptp(mlat, axis=1)) < 1e-6
    # an ESA ISS archive cache (api.json, metadata.json, the frame and its
    # .wcs) converts through the ISS provider: --grid geo to CDF and to
    # netCDF, both equal to the JAX CLI's (float64, grids 1e-9 deg, masks
    # and uint8 image equal, the archive's metadata carried over)
    iss_folder = make_iss_cache(small_folder, tmp_path / "iss")
    assert convert.detect_source_type(iss_folder) == "iss"
    for fmt, read, jread in (("cdf", jread_cdf, jread_cdf),
                             ("netcdf", read_nc, jread_nc)):
        iss_args = [iss_folder, "--grid", "geo", "--arcsecperpx", "900",
                    "--format", fmt]
        assert jconvert.main(iss_args + ["--out", str(tmp_path / "jiss")]) == 0
        assert convert.main(CPU + iss_args + ["--out",
                                              str(tmp_path / "piss")]) == 0
        ext = ".cdf" if fmt == "cdf" else ".nc"
        m = read(str(tmp_path / "piss" / f"{ISS_KEY}{ext}"))
        jm = jread(str(tmp_path / "jiss" / f"{ISS_KEY}{ext}"))
        m.checkPlateCarree()
        for name in ("lats", "lons", "latsCenter", "lonsCenter"):
            a, b = getattr(m, name).data, getattr(jm, name).data
            assert a.shape == b.shape and np.abs(a - b).max() < 1e-9
        assert np.array_equal(m.center_mask, jm.center_mask)
        assert (~m.center_mask).sum() > 300
        assert np.array_equal(m.img.filled(0), jm.img.filled(0))
        assert m.metadata["Project"] == jm.metadata["Project"] == "THOR"
    # a MIRACLE folder without images converts nothing (tests/test_torch_asi.py
    # converts real ones)
    (tmp_path / "asi").mkdir()
    (tmp_path / "asi" / "cal.txt").write_text("")
    assert convert.main(CPU + [str(tmp_path / "asi")]) == 0
    assert os.listdir(tmp_path / "asi") == ["cal.txt"]


def test_provider_batched_and_masking(small_folder):
    prov = sc.SpacecraftMappingProvider(small_folder, fast_center=True,
                                        device="cpu")
    (m64,) = prov.getSequence()
    (m32,) = prov.getSequenceBatched(batch=4)
    assert prov.getById("small").identifier == m64.identifier == "small"
    assert m32.identifier == "small"
    both = ~m64.center_mask & ~m32.center_mask
    assert both.mean() > 0.3
    clear = both & (m64.elevation.data > 5)
    assert np.abs(m64.latsCenter.data - m32.latsCenter.data)[clear].max() < 2e-4
    masked = m64.maskedByElevation(10)
    assert masked.center_mask.sum() > m64.center_mask.sum()
    assert (masked.elevation.compressed() >= 10).all()
    assert masked._mlatmlt is not None  # J2000 MLat/MLT carried over
    with pytest.raises(ValueError, match="mask all"):
        m64.maskedByElevation(95)
    with pytest.raises(ValueError, match="maxTimeOffset"):
        prov.get(m64.photoTime + dt.timedelta(hours=1))
    assert prov.get(m64.photoTime).identifier == "small"


@pytest.mark.parametrize("platform", [["--platform", "cuda"], []],
                         ids=["cuda", "default"])
def test_platform_cuda_without_a_card_exits_nonzero(small_folder, platform):
    """``--platform cuda``, and no ``--platform`` (cuda is the default),
    fail without a card; nothing falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = run_port("-m", "auromat_tpu_torch.cli.convert", small_folder,
                   *platform, "--out", small_folder, env=env)
    assert res.returncode != 0
    assert "cuda" in res.stderr and "wrote" not in res.stdout


def test_port_modules_import_no_jax():
    res = run_port("-c", (
        "import sys\n"
        "import auromat_tpu_torch.parallel, auromat_tpu_torch.cli.convert\n"
        "import auromat_tpu_torch.export.cdf, auromat_tpu_torch.export.netcdf\n"
        "import auromat_tpu_torch.mapping.spacecraft, auromat_tpu_torch.entry\n"
        "import auromat_tpu_torch.mapping.iss, auromat_tpu_torch.mapping.cdf\n"
        "import auromat_tpu_torch.mapping.netcdf, auromat_tpu_torch.profiling\n"
        "import auromat_tpu_torch.coordinates.ephem\n"
        "import auromat_tpu_torch.coordinates.spacetrack\n"
        "import auromat_tpu_torch.util.lensdistortion\n"
        "import auromat_tpu_torch.util.exiftool, auromat_tpu_torch.cli.download\n"
        "import auromat_tpu_torch.solving, auromat_tpu_torch.solving.masking\n"
        "import auromat_tpu_torch.solving.noise\n"
        "import auromat_tpu_torch.solving.solving\n"
        "import auromat_tpu_torch.solving.spacecraft\n"
        "import auromat_tpu_torch.solving.eol, auromat_tpu_torch.io.fits\n"
        "import auromat_tpu_torch.util.url, auromat_tpu_torch.util.histogram\n"
        "import auromat_tpu_torch.util.decorators\n"
        "import auromat_tpu_torch.util.coroutine, auromat_tpu_torch.util.movie\n"
        "import auromat_tpu_torch.coordinates.constellations\n"
        "import auromat_tpu_torch.utils\n"
        "import auromat_tpu_torch.draw, auromat_tpu_torch.draw_helpers\n"
        "import auromat_tpu_torch.debug, auromat_tpu_torch.coastlines\n"
        "from auromat_tpu_torch.coordinates.constellations import bright_stars\n"
        "bright_stars()\n"
        "auromat_tpu_torch.coastlines.land_rings()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'auromat_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"))
    assert res.returncode == 0, res.stdout + res.stderr


def test_drawing_layer_imports_without_matplotlib_or_pil():
    """The card's machine has neither: the four drawing modules import, the
    numeric helpers run, and a figure function raises the ImportError."""
    res = run_port("-c", (
        "import sys\n"
        "sys.modules['matplotlib'] = sys.modules['PIL'] = None\n"
        "import auromat_tpu_torch.draw as draw\n"
        "import auromat_tpu_torch.draw_helpers, auromat_tpu_torch.debug\n"
        "import auromat_tpu_torch.coastlines as c\n"
        "x, y = draw.stereographic_project(*c.city_points()[:2], 60, -100)\n"
        "assert x.shape == c.city_points()[0].shape\n"
        "import datetime, numpy as np\n"
        "from auromat_tpu_torch.mapping.mapping import Mapping\n"
        "lat, lon = np.meshgrid(np.linspace(50, 52, 4), "
        "np.linspace(-100, -96, 5), indexing='ij')\n"
        "mid = lambda a: (a[1:, 1:] + a[:-1, :-1]) / 2\n"
        "m = Mapping(lat, lon, mid(lat), mid(lon), np.full((3, 4), 30.0), "
        "110.0, np.zeros((3, 4, 3), np.uint8), np.array([0.0, 0.0, 7000.0]), "
        "datetime.datetime(2012, 1, 25), 'tiny')\n"
        "try:\n"
        "    draw.draw_plot(m)\n"
        "except ImportError as e:\n"
        "    print('ImportError', e)\n"
        "else:\n"
        "    sys.exit(2)\n"
        "try:\n"
        "    draw.draw_histogram([1.0, 2.0])\n"
        "except ImportError:\n"
        "    print('ImportError')\n"
        "else:\n"
        "    sys.exit(3)\n"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("ImportError") == 2


@pytest.mark.parametrize("argv", [
    ["esa-iss", "F", "--id", "77"],
    ["esa-iss", "F", "--id", "77", "--no-raw", "--start", "2012-01-25",
     "--end", "2012-01-26T10:00:00"],
    ["themis", "F", "--start", "2012-02-04", "--end", "2012-02-04 08:00:00",
     "--stations", "fsmi", "gill"],
])
def test_download_cli_parser_matches_jax(argv):
    from auromat_tpu.cli import download as jdownload
    from auromat_tpu_torch.cli import download

    assert vars(download.build_parser().parse_args(argv)) == \
        vars(jdownload.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["esa-iss", "F"], ["themis", "F", "--start", "2012-02-04"],
    ["esa-iss", "F", "--id", "77", "--start", "yesterday"],
])
def test_download_cli_refuses_bad_arguments(argv, capsys):
    from auromat_tpu_torch.cli import download

    with pytest.raises(SystemExit) as e:
        download.build_parser().parse_args(argv)
    assert e.value.code == 2


def test_download_cli_esa_iss_from_file_uris(tmp_path, capsys, monkeypatch):
    """``esa-iss`` fetches a sequence through the port's provider (file://
    URIs, no network) and needs no card."""
    import json

    server = tmp_path / "server"
    server.mkdir()
    shutil.copy(os.path.join(RES, f"{FRAME}.wcs"), server / "f.wcs")
    (server / "f.jpg").write_bytes(b"not decoded by a download")
    (server / "meta.json").write_text("{}")
    date = "2012-01-25T09:27:08.060000"
    (server / "77").write_text(json.dumps({
        "id": 77, "date_start": date, "date_end": date,
        "image_extension": ".jpg",
        "metadata_uri": (server / "meta.json").as_uri(),
        "images": {ISS_KEY: {"date": date,
                             "image_uri": (server / "f.jpg").as_uri(),
                             "wcs_uri": (server / "f.wcs").as_uri()}}}))
    from auromat_tpu_torch.cli import download
    from auromat_tpu_torch.mapping import iss

    iss_init = iss.ISSMappingProvider.__init__

    def init(self, *a, **k):  # the archive at the file:// URIs above
        iss_init(self, *a, baseUrl=server.as_uri() + "/", **k)

    monkeypatch.setattr(iss.ISSMappingProvider, "__init__", init)
    assert download.main(["esa-iss", str(tmp_path / "cache"), "--id", "77",
                          "--no-raw"]) == 0
    assert "downloaded 1 frames" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "cache")) == [
        f"{ISS_KEY}.jpg", f"{ISS_KEY}.wcs", "api.json", "metadata.json"]
