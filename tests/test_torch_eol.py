"""The port's EOL downloaders (``auromat_tpu_torch.solving.eol``) against the
JAX package, both driven against one local fake archive server
(tests/test_eol_raw.py's ``FakeEOL``: photo pages, frame probes, the RAW
order endpoint, staging after two polls; no test touches the network).

* The RAW order/poll pipeline: the same orders, polls, files (names and
  bytes) and sidecar (its ``updated`` time aside) from each package; the
  resume short-circuit; a missing end frame and stalled staging refused
  alike.
* ``extract_aurora_sequences``, ``download_image_sequence`` and
  ``download_images_jpg`` (URL constants pointed at the fake) equal.
* ``_raw_filename_pattern``, ``filename_of``/``frame_iter``/
  ``filename_iter`` and ``SequenceMetadata`` equal.
* ``correct_lens_distortion`` over a folder on the CPU equal to JAX's.
"""

import http.server
import os
import threading

import numpy as np
import pytest

from auromat_tpu.solving import eol as jeol
from auromat_tpu_torch.solving import eol
from tests.test_eol_raw import FakeEOL, _urls

KW = dict(poll_interval=0.01, stall_timeout=5.0, sleep=lambda s: None)


@pytest.fixture()
def server():
    FakeEOL.state = {"orders": {}, "polls": {}, "gap_frames": {102}}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), FakeEOL)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _reset():
    FakeEOL.state.update(orders={}, polls={})


def _files(folder):
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder)) if not f.startswith("_")}


def _meta(meta):
    return {k: v for k, v in meta.data.items() if k != "updated"}


def test_raw_pipeline_matches_jax(server, tmp_path):
    runs = {}
    for name, mod in (("port", eol), ("jax", jeol)):
        _reset()
        folder = str(tmp_path / name)
        meta, failures = mod.download_image_sequence_raw(
            folder, "ISS030", 100, 104, urls=_urls(server), **KW)
        state = {k: dict(v) for k, v in FakeEOL.state.items()
                 if k in ("orders", "polls")}
        # resume: the sidecar short-circuits, nothing is ordered again
        again, fail2 = mod.download_image_sequence_raw(
            folder, "ISS030", 100, 104, urls=_urls(server), **KW)
        assert fail2 == [] and FakeEOL.state["orders"] == state["orders"]
        runs[name] = (failures, _meta(meta), state, _files(folder),
                      [(f, n) for f, n in mod.filename_iter(meta)])
    assert runs["port"] == runs["jax"]
    failures, meta, state, files, names = runs["port"]
    assert failures == [] and meta["rawFrameGaps"] == [102]
    assert sorted(files) == [f"ISS030-E-{f}.nef" for f in (100, 101, 103, 104)]
    assert names == [(f"ISS030-E-{f}.nef", f) for f in (100, 101, 103, 104)]


def test_raw_refusals_match_jax(server, tmp_path):
    FakeEOL.state["gap_frames"] = {104}
    for mod in (eol, jeol):
        _reset()
        with pytest.raises(ValueError, match="not downloadable"):
            mod.download_image_sequence_raw(str(tmp_path / mod.__name__),
                                            "ISS030", 100, 104,
                                            urls=_urls(server), **KW)
    orig = FakeEOL.do_GET

    def never_stage(self):
        if self.path.startswith("/raw/"):
            self._reply(404)
        else:
            orig(self)

    FakeEOL.do_GET = never_stage
    try:
        got = []
        for mod in (eol, jeol):
            _reset()
            meta, failures = mod.download_image_sequence_raw(
                str(tmp_path / ("stall" + mod.__name__)), "ISS030", 100, 101,
                urls=_urls(server), poll_interval=0.0, stall_timeout=0.05,
                sleep=lambda s: None)
            got.append((meta, [u for u, _ in failures]))
    finally:
        FakeEOL.do_GET = orig
    assert got[0] == got[1] and got[0][0] is None and len(got[0][1]) == 2


def test_sequence_index_and_jpeg_downloads_match_jax(server, tmp_path,
                                                     monkeypatch):
    seqs = eol.extract_aurora_sequences(url=server + "/aurora.htm")
    assert [tuple(s) for s in seqs] == [
        tuple(s) for s in jeol.extract_aurora_sequences(
            url=server + "/aurora.htm")]
    assert seqs[0].title == "Aurora Australis over Indian Ocean"
    s0 = seqs[0]
    template = server + "/jpg/{mission}-E-{frame}.JPG"
    got = {}
    for name, mod in (("port", eol), ("jax", jeol)):
        folder = str(tmp_path / name)
        downloaded, missing = mod.download_image_sequence(
            folder, s0.mission, s0.from_frame, s0.to_frame,
            url_template=template)
        meta = mod.SequenceMetadata(folder)
        monkeypatch.setattr(mod, "JPEG_URL_PATTERN",
                            server + "/jpg/{mission}-{roll}-{frame}.JPG")
        ids = [("ISS030", "E", 100), ("ISS030", "E", 101)]
        paths = mod.download_images(str(tmp_path / (name + "_ids")), ids)
        gap = mod.download_images_jpg(str(tmp_path / (name + "_gap")),
                                      [("ISS030", "E", 102)])
        got[name] = ([os.path.basename(p) for p in downloaded], missing,
                     _meta(meta), list(mod.frame_iter(meta)),
                     [os.path.basename(p) for p in paths], gap,
                     _files(folder))
        with pytest.raises(NotImplementedError):
            mod.download_images(folder, ids, format_="raw")
        with pytest.raises(ValueError):
            mod.download_images(folder, ids, format_="tif")
    assert got["port"] == got["jax"]
    assert got["port"][1] == [102] and got["port"][3] == [100, 101, 103, 104]
    assert got["port"][5] is False


@pytest.mark.parametrize("raw_name,mission,roll,frame", [
    ("iss030e102170.NEF", "ISS030", "E", 102170),
    ("ISS030-E-102170.nef", "ISS030", "E", 102170),
    ("iss029e008492.NEF", "ISS029", "E", 8492),
    ("iss029e8492.CR2", "ISS029", "E", 8492),
])
def test_raw_filename_pattern_matches_jax(raw_name, mission, roll, frame):
    full, fmt = eol._raw_filename_pattern(raw_name, mission, roll, frame)
    jfull, jfmt = jeol._raw_filename_pattern(raw_name, mission, roll, frame)
    assert full == jfull and fmt(frame) == raw_name
    assert [fmt(f) for f in (frame + 1, 7, 123456)] == \
        [jfmt(f) for f in (frame + 1, 7, 123456)]


def test_raw_filename_pattern_refusals_match_jax():
    for args in (("x.NEF", "ISS030", "E", 1), ("iss030x5.NEF", "ISS030", "E", 5),
                 ("iss030e9.NEF", "ISS030", "E", 5)):
        for mod in (eol, jeol):
            with pytest.raises(RuntimeError):
                mod._raw_filename_pattern(*args)


def test_metadata_and_frame_names_match_jax(tmp_path):
    for mod in (eol, jeol):
        folder = tmp_path / mod.__name__.split(".")[0]
        folder.mkdir()
        m = mod.SequenceMetadata(str(folder))
        m.update(mission="ISS030", fromFrame=5, toFrame=9, missing=[7])
        m2 = mod.SequenceMetadata(os.path.dirname(m.path))
        assert m2["toFrame"] == 9 and m2.get("nope", 3) == 3
    meta = {"mission": "ISS030", "roll": "E", "rawFromFrame": 1,
            "rawToFrame": 4, "rawFrameGaps": [2], "raw": True,
            "pattern": "ISS030-E-{frame}.nef"}
    for m in (meta, {"mission": "ISS030", "fromFrame": 1, "toFrame": 3}):
        assert list(eol.filename_iter(m)) == list(jeol.filename_iter(m))
        assert eol.filename_of(3, m) == jeol.filename_of(3, m)
    assert eol.frame_id("ISS030", 102170) == "ISS030-E-102170"
    for mod in (eol, jeol):
        with pytest.raises(KeyError):
            list(mod.frame_iter({"mission": "ISS030"}))


def test_correct_lens_distortion_folder_matches_jax(tmp_path):
    from auromat_tpu.io.image import save_image

    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i in range(2):
        save_image(str(src / f"f{i}.png"),
                   rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    (src / "notes.txt").write_text("skipped")
    kw = dict(model="poly3", params=(-0.019,))
    ours = eol.correct_lens_distortion(str(src), str(tmp_path / "a"),
                                       device="cpu", **kw)
    theirs = jeol.correct_lens_distortion(str(src), str(tmp_path / "b"), **kw)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs] == ["f0.png", "f1.png"]
    from auromat_tpu.io.image import load_image

    for a, b in zip(ours, theirs):
        assert np.array_equal(load_image(a), load_image(b))
