"""The port's image I/O (auromat_tpu_torch.io.image) against the JAX
package's on the CPU: ``save_image`` (uint8, uint16 scaled to uint8,
masked entries written as 0) read back by both loaders, ``cropped_image``,
the EXIF readers on a JPEG written with EXIF tags (capture time with its
sub-second part, 35 mm focal length, exposure time, and None without
tags), ``convert_exif_date``, and ``image_to_mpl``/``image_to_cv`` on
uint8, uint16, float, masked and grayscale images: equal results. The
port's copy of ``util.exiftool`` over a stand-in binary that speaks
exiftool's ``-stay_open`` protocol (no exiftool here)."""

from datetime import datetime

import numpy as np
import pytest

from auromat_tpu.io import image as J
from auromat_tpu_torch.io import image as T

RNG = np.random.default_rng(21)
U8 = RNG.integers(0, 256, (30, 41, 3), dtype=np.uint8)
U16 = RNG.integers(0, 65536, (30, 41, 3), dtype=np.uint16)
MASK = RNG.random((30, 41, 3)) < 0.2


@pytest.mark.parametrize("kind", ["uint8", "uint16", "masked"])
def test_save_image_matches_jax(tmp_path, kind):
    img = {"uint8": U8, "uint16": U16,
           "masked": np.ma.masked_array(U8, MASK)}[kind]
    T.save_image(str(tmp_path / "t.png"), img)
    J.save_image(str(tmp_path / "j.png"), img)
    ours = T.load_image(str(tmp_path / "t.png"))
    assert np.array_equal(ours, J.load_image(str(tmp_path / "j.png")))
    assert ours.dtype == np.uint8 and ours.shape == U8.shape
    if kind == "masked":
        assert (ours[MASK] == 0).all()


def test_cropped_image_matches_jax():
    for div in (1, 8, 16):
        a, b = T.cropped_image(U8, div), J.cropped_image(U8, div)
        assert a.shape == b.shape and np.array_equal(a, b)
    assert T.cropped_image(U8, 16).shape == (16, 32, 3)


def test_exif_readers_match_jax(tmp_path):
    from PIL import Image

    path = str(tmp_path / "exif.jpg")
    exif = Image.Exif()
    ifd = exif.get_ifd(0x8769)
    ifd[0x9003] = "2012:01:25 09:27:08"  # DateTimeOriginal
    ifd[0x9291] = "06"  # SubsecTimeOriginal
    ifd[0xA405] = 24  # FocalLengthIn35mmFilm
    ifd[0x829A] = 0.5  # ExposureTime
    Image.fromarray(U8).save(path, exif=exif)
    t = T.read_exif_time(path)
    assert t == J.read_exif_time(path) == datetime(2012, 1, 25, 9, 27, 8,
                                                   60000)
    assert T.read_focal_length_35mm(path) == \
        J.read_focal_length_35mm(path) == 24.0
    assert T.read_exposure_time(path) == J.read_exposure_time(path) == 0.5
    plain = str(tmp_path / "plain.jpg")
    Image.fromarray(U8).save(plain)
    for fn in ("read_exif_time", "read_focal_length_35mm",
               "read_exposure_time"):
        assert getattr(T, fn)(plain) is None is getattr(J, fn)(plain)


@pytest.mark.parametrize("date,sub", [("2012:01:25 09:27:08", None),
                                      ("2012:01:25 09:27:08", "06"),
                                      ("2012:01:25 09:27:08", 6),
                                      ("2012:01:25 09:27:08", " 123 "),
                                      ("2012:01:25 09:27:08", "n/a")])
def test_convert_exif_date_matches_jax(date, sub):
    assert T.convert_exif_date(date, sub) == J.convert_exif_date(date, sub)


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float", "masked",
                                  "gray"])
def test_image_conversions_match_jax(kind):
    img = {"uint8": U8, "uint16": U16, "float": U8 / 255.0,
           "masked": np.ma.masked_array(U8, MASK), "gray": U8[..., 0]}[kind]
    for fn in ("image_to_mpl", "image_to_cv"):
        a, b = getattr(T, fn)(img), getattr(J, fn)(img)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    if kind == "masked":
        assert (T.image_to_cv(img)[MASK[..., ::-1]] == 0).all()


FAKE_EXIFTOOL = r'''
import json, sys
args = []
for line in sys.stdin:
    line = line.rstrip("\n")
    if line == "-stay_open" or (args and args[-1] == "-stay_open"):
        args.append(line)
        if line == "False":
            break
        continue
    if line != "-execute":
        args.append(line)
        continue
    if "-j" in args:
        files = [a for a in args if not a.startswith("-")]
        tags = [a[1:] for a in args if a.startswith("-") and a != "-j"]
        out = [dict({"SourceFile": f, "File:ImageWidth": 8},
                    **{f"EXIF:{t}": 24 for t in tags}) for f in files]
        sys.stdout.write(json.dumps(out) + "\n")
    else:
        sys.stdout.write("    1 image files updated\n")
    sys.stdout.write("{ready}\n")
    sys.stdout.flush()
    args = []
'''


def test_exiftool_batch_process_with_a_fake_binary(tmp_path, monkeypatch):
    """The port's ExifTool over a stand-in binary speaking exiftool's
    ``-stay_open`` protocol (no exiftool here), and its refusal without
    one, as the JAX package's."""
    import os
    import sys

    from auromat_tpu_torch.util import exiftool

    exe = tmp_path / "exiftool"
    exe.write_text(f"#!{sys.executable}\n{FAKE_EXIFTOOL}")
    os.chmod(exe, 0o755)
    with exiftool.ExifTool(executable=str(exe)) as et:
        assert et.running
        meta = et.get_metadata(tmp_path / "a.jpg")
        assert meta == {"SourceFile": str(tmp_path / "a.jpg"),
                        "File:ImageWidth": 8}
        assert et.get_tag(tmp_path / "a.jpg", "FocalLength") == 24
        batch = et.get_metadata_batch(["x.jpg", "y.jpg"])
        assert [m["SourceFile"] for m in batch] == ["x.jpg", "y.jpg"]
        assert b"updated" in et.copy_tags("a.nef", "a.jpg")
    assert not et.running
    monkeypatch.setattr(exiftool.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="not found"):
        exiftool.ExifTool()
