"""The port's small utilities against the JAX package on the CPU.

* ``util.url``: ``download_json``, ``download_files``, ``url_response_code``,
  ``fetch_text`` and ``download_resource`` against a local ``http.server``
  (no test touches the network), the same results as JAX's.
* ``util.decorators``, ``util.coroutine``: the same behaviour.
* ``util.movie.create_movie`` with a stand-in ``ffmpeg`` (a POSIX ``sh``
  script, as tests/test_movie.py): the same command line as JAX's.
* ``util.histogram.histogram2d`` with a list of weights (torch on the CPU):
  counts equal to JAX's and to golden_histogram2d.npz (the executed
  reference), sums within 1e-12 relative; the right-most edge inclusive,
  NaN and out-of-range samples dropped; the single-weight case and
  ``histogramdd`` numpy passthroughs.
* ``coordinates.constellations``: the resource's bytes equal the JAX
  package's, and the figures and bright stars equal.
* ``utils``: the tensor vector helpers (dtype and device kept) within
  1e-15 of JAX's numpy, ``without_consecutive_duplicates`` equal.
"""

import http.server
import os
import stat
import threading

import numpy as np
import pytest
import torch

from auromat_tpu import utils as jutils
from auromat_tpu.coordinates import constellations as jconst
from auromat_tpu.util import coroutine as jco
from auromat_tpu.util import histogram as jhist
from auromat_tpu.util import movie as jmovie
from auromat_tpu.util import url as jurl
from auromat_tpu_torch import utils
from auromat_tpu_torch.coordinates import constellations
from auromat_tpu_torch.util import coroutine, decorators, histogram, movie, url

RES = os.path.join(os.path.dirname(__file__), "resources")


class Files(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        bodies = {"/data.json": b'{"a": [1, 2.5, "x"]}',
                  "/page.html": "<p>café</p>".encode(),
                  "/bin": bytes(range(256))}
        body = bodies.get(self.path)
        self.send_response(200 if body is not None else 404)
        body = body or b""
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Files)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_url_helpers_match_jax(server, tmp_path):
    for mod in (url, jurl):
        assert mod.download_json(server + "/data.json") == {"a": [1, 2.5, "x"]}
        assert mod.fetch_text(server + "/page.html") == "<p>café</p>"
        assert mod.url_response_code(server + "/bin") == 200
        assert mod.url_response_code(server + "/none") == 404
        assert mod.download_resource(server + "/bin", len) == 256
        with pytest.raises(mod.DownloadError):
            mod.download_resource(server + "/none", len)
        with pytest.raises(mod.DownloadError):
            mod.download_json(server + "/none")
    pairs = [(server + "/bin", str(tmp_path / "a" / "bin")),
             (server + "/none", str(tmp_path / "b" / "none"))]
    fails = url.download_files(pairs, ignore_errors=True)
    jfails = jurl.download_files([(u, p + "j") for u, p in pairs],
                                 ignore_errors=True)
    assert [(u, os.path.basename(p)) for u, p, _ in fails] == \
        [(u, os.path.basename(p)[:-1]) for u, p, _ in jfails] == \
        [(server + "/none", "none")]
    assert (tmp_path / "a" / "bin").read_bytes() == bytes(range(256))
    assert not os.path.exists(pairs[1][1]) and \
        not os.path.exists(pairs[1][1] + ".tmp")
    with pytest.raises(url.DownloadError):
        url.download_files(pairs)


def test_decorators():
    calls = []

    class Base:
        def method(self):
            """Documented in the base."""

    @decorators.inherit_docs
    class C(Base):
        @decorators.lazy_property
        def value(self):
            calls.append(1)
            return 42

        def method(self):
            pass

    c = C()
    assert c.value == 42 and c.value == 42 and len(calls) == 1
    assert C.method.__doc__ == "Documented in the base."
    before = np.get_printoptions()
    with decorators.printoptions(precision=2):
        assert np.get_printoptions()["precision"] == 2
    assert np.get_printoptions() == before


@pytest.mark.parametrize("mod", [coroutine, jco], ids=["port", "jax"])
def test_coroutines(mod):
    got = {"a": [], "b": [], "closed": 0}

    @mod.coroutine
    def sink(name):
        try:
            while True:
                got[name].append((yield))
        except GeneratorExit:
            got["closed"] += 1

    mod.feed(range(4), mod.broadcast([sink("a"), sink("b")]))
    assert got == {"a": [0, 1, 2, 3], "b": [0, 1, 2, 3], "closed": 2}
    target = sink("a")
    with pytest.raises(KeyError, match="boom"):
        mod.throw(target, KeyError, "boom", None)


def _fake_ffmpeg(tmp_path, exit_code=0, stderr_msg=""):
    fake = tmp_path / "ffmpeg"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {tmp_path}/argv.txt\n'
        'out=""\n'
        'for a in "$@"; do out="$a"; done\n'
        f'[ {exit_code} -eq 0 ] && touch "$out"\n'
        f'echo "{stderr_msg}" >&2\n'
        f"exit {exit_code}\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return str(fake)


@pytest.mark.parametrize("name,kw", [("m.mp4", {"fps": 12}),
                                     ("m.webm", {"width": 640, "crf": 4})])
def test_movie_command_matches_jax(tmp_path, name, kw):
    frames = []
    for i in range(3):
        p = tmp_path / f"frame_{i:03d}.png"
        p.write_bytes(b"png")
        frames.append(str(p))
    fake = _fake_ffmpeg(tmp_path)
    out = str(tmp_path / name)
    assert movie.create_movie(out, frames, ffmpeg=fake, **kw) == out
    jmovie.create_movie(out, frames, ffmpeg=fake, **kw)
    ours, theirs = (tmp_path / "argv.txt").read_text().splitlines()
    # the frames' temp dirs differ; everything else is the same command
    strip = lambda s: [a for a in s.split() if "auromat_movie_" not in a]
    assert strip(ours) == strip(theirs) and os.path.exists(out)
    with pytest.raises(RuntimeError, match="odd width"):
        movie.create_movie(out, frames, ffmpeg=_fake_ffmpeg(
            tmp_path, 1, "odd width"))
    with pytest.raises(ValueError, match="unsupported movie container"):
        movie.create_movie(str(tmp_path / "x.avi"), frames, ffmpeg=fake)


def _assert_hists(ours, theirs):
    hists, xe, ye = ours
    jhists, jxe, jye = theirs
    assert np.array_equal(xe, jxe) and np.array_equal(ye, jye)
    assert np.array_equal(hists[0], jhists[0])  # counts
    for h, j in zip(hists[1:], jhists[1:]):
        assert h.dtype == np.float64
        np.testing.assert_allclose(h, j, rtol=1e-12, atol=0)


def test_histogram2d_golden_and_jax():
    g = np.load(os.path.join(RES, "golden_histogram2d.npz"))
    args = (g["x"], g["y"])
    kw = dict(bins=tuple(g["bins"]), range=[list(r) for r in g["range"]],
              weights=[None, g["w1"], g["w2"]])
    ours = histogram.histogram2d(*args, device="cpu", **kw)
    _assert_hists(ours, jhist.histogram2d(*args, **kw))
    hists, xe, ye = ours
    assert np.array_equal(xe, g["xedges"]) and np.array_equal(ye, g["yedges"])
    assert np.array_equal(hists[0], g["count"])
    np.testing.assert_allclose(hists[1], g["h1"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(hists[2], g["h2"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_histogram2d_edges_nan_and_tensors(dtype):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 11, 5000).astype(dtype)
    y = rng.uniform(-2, 6, 5000).astype(dtype)
    x[:10] = 10.0  # on the right-most edge: inclusive
    y[10:20] = np.nan
    x[20:30] = -np.inf
    x[30:40], y[30:40] = 10.1, 1.0  # float32(10.1) > 10.1
    w = rng.random(5000)
    for rng_, bins in (([[0, 10], [-1, 5]], (7, 5)),
                       ([[0, 10.1], [-1, 5]], (7, 5)),
                       ([[0, np.float64(10.1)], [-1, 5]], (7, 5)),
                       (None, 6)):
        kw = dict(bins=bins, range=rng_, weights=[None, w, w * w])
        if rng_ is None:  # NaN-free data for the data-derived range
            xs, ys, kw["weights"] = x[30:], y[30:], [None, w[30:]]
        else:
            xs, ys = x, y
        _assert_hists(histogram.histogram2d(xs, ys, device="cpu", **kw),
                      jhist.histogram2d(xs, ys, **kw))
        _assert_hists(histogram.histogram2d(torch.from_numpy(xs),
                                            torch.from_numpy(ys),
                                            device="cpu", **kw),
                      jhist.histogram2d(xs, ys, **kw))
    # the right edge compares as numpy's x == xhi: a Python float meets
    # float32 samples in float32, a numpy float64 in float64
    edge = [histogram.histogram2d(x[30:40], y[30:40], (7, 5),
                                  range=[[0, hi], [-1, 5]], weights=[None],
                                  device="cpu")[0][0][-1].sum()
            for hi in (10.1, np.float64(10.1))]
    assert edge == ([10, 0] if dtype == np.float32 else [10, 10])


def test_histogram_passthroughs():
    rng = np.random.default_rng(6)
    x, y, w = rng.random(100), rng.random(100), rng.random(100)
    for a, b in zip(histogram.histogram2d(x, y, 4, weights=w),
                    jhist.histogram2d(x, y, 4, weights=w)):
        assert np.array_equal(a, b)
    sample = np.stack([x, y], 1)
    for a, b in zip(histogram.histogramdd(sample, 3),
                    jhist.histogramdd(sample, 3)):
        assert np.array_equal(np.asarray(a, dtype=object),
                              np.asarray(b, dtype=object))
    _assert_hists(histogram.histogramdd(sample, 3, weights=[None, w],
                                        device="cpu"),
                  jhist.histogramdd(sample, 3, weights=[None, w]))


def test_constellations_match_jax():
    ours = os.path.join(os.path.dirname(constellations.__file__), os.pardir,
                        "resources", "constellations.npz")
    theirs = os.path.join(os.path.dirname(jconst.__file__), os.pardir,
                          "resources", "constellations.npz")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert os.path.realpath(constellations._RESOURCE) == os.path.realpath(ours)
    data, jdata = constellations.load(), jconst.load()
    assert list(data) == list(jdata) and len(data) > 80
    for k in data:
        assert np.array_equal(data[k], jdata[k])
    assert constellations.figure_segments() == jconst.figure_segments()
    assert constellations.figure_segments("Orion") == \
        jconst.figure_segments("Orion")
    assert np.array_equal(constellations.bright_stars(), jconst.bright_stars())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vector_helpers_match_jax(dtype):
    rng = np.random.default_rng(7)
    v1, v2 = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    t1, t2 = torch.from_numpy(v1).to(dtype), torch.from_numpy(v2).to(dtype)
    n1, n2 = t1.double().numpy(), t2.double().numpy()
    tol = 1e-15 if dtype == torch.float64 else 1e-6
    checks = [
        (utils.vector_lengths(t1), jutils.vector_lengths(n1)),
        (utils.vector_lengths(t1, axis=0), jutils.vector_lengths(n1, axis=0)),
        (utils.unit_vectors(t1), jutils.unit_vectors(n1)),
        (utils.angle_between(utils.unit_vectors(t1), utils.unit_vectors(t2)),
         jutils.angle_between(jutils.unit_vectors(n1),
                              jutils.unit_vectors(n2))),
        (utils.signed_angle_between(t1[:, :2], t2[:, :2]),
         jutils.signed_angle_between(n1[:, :2], n2[:, :2])),
    ]
    for got, want in checks:
        assert got.dtype == dtype and got.device.type == "cpu"
        np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                                   atol=tol * 10)
    # parallel unit vectors: the clamp keeps arccos finite
    u = utils.unit_vectors(t1)
    assert torch.isfinite(utils.angle_between(u, u)).all()
    # tensors only: an array would compute on the host unasked
    for call in (lambda: utils.vector_lengths(n1),
                 lambda: utils.unit_vectors(n1),
                 lambda: utils.angle_between(t1, n2),
                 lambda: utils.signed_angle_between(n1[:, :2], t2[:, :2])):
        with pytest.raises(TypeError, match="expected a tensor"):
            call()


def test_without_consecutive_duplicates_matches_jax():
    pts = np.array([[0, 0], [0, 0], [1, 0], [1, 0], [1, 1], [0, 0], [0, 0]])
    for p in (pts, pts[:1], pts[:0].reshape(0, 2)):
        assert np.array_equal(utils.without_consecutive_duplicates(p),
                              jutils.without_consecutive_duplicates(p))
    assert len(utils.without_consecutive_duplicates(pts)) == 4
