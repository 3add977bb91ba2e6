"""NASA Earth Observation Laboratory (EOL) image sequence downloader.

Functional equivalent of auromat/solving/eol.py: downloads continuous
mission/frame sequences of ISS photographs (JPEG), tolerating small frame
gaps, and keeps a JSON metadata sidecar describing the sequence. RAW (NEF)
request/polling against the EOL order system is represented by the same
public entry points but requires network credentials not available in tests.
Counterpart of ``auromat_tpu.solving.eol``; :func:`correct_lens_distortion`
corrects on ``device``, the card by default.
"""

import json
import os
from collections import namedtuple
from datetime import datetime

from auromat_tpu_torch.util.url import DownloadError, download_file

Sequence = namedtuple(
    "Sequence",
    ["mission", "roll", "from_frame", "to_frame", "title", "url_anchor"],
)

LARGE_JPEG_URL = (
    "https://eol.jsc.nasa.gov/DatabaseImages/ESC/large/{mission}/{mission}-E-{frame}.JPG"
)

METADATA_FILENAME = "_metadata.json"


class SequenceMetadata:
    """JSON sidecar for a downloaded sequence (reference eol.py:57-78)."""

    def __init__(self, folder):
        self.path = os.path.join(folder, METADATA_FILENAME)
        self.data = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.data = json.load(f)

    def update(self, **kw):
        self.data.update(kw)
        self.data["updated"] = datetime.now().isoformat()
        with open(self.path, "w") as f:
            json.dump(self.data, f, indent=2, sort_keys=True)

    def __getitem__(self, key):
        return self.data[key]

    def get(self, key, default=None):
        return self.data.get(key, default)


def frame_id(mission, frame):
    return f"{mission}-E-{frame}"


def download_image_sequence(folder, mission, from_frame, to_frame,
                            max_gap=10, url_template=LARGE_JPEG_URL):
    """Download frames [from_frame, to_frame] of a mission into ``folder``.

    Missing frames are tolerated up to ``max_gap`` consecutive failures
    (reference eol.py:208-227 frame-gap tolerance). Already-present files are
    skipped (resume semantics).

    :returns: (downloaded paths, missing frame numbers)
    """
    os.makedirs(folder, exist_ok=True)
    meta = SequenceMetadata(folder)
    downloaded, missing = [], []
    gap = 0
    for frame in range(from_frame, to_frame + 1):
        name = frame_id(mission, frame) + ".jpg"
        path = os.path.join(folder, name)
        if os.path.exists(path):
            downloaded.append(path)
            gap = 0
            continue
        url = url_template.format(mission=mission, frame=frame)
        try:
            download_file(url, path)
            downloaded.append(path)
            gap = 0
        except DownloadError:
            missing.append(frame)
            gap += 1
            if gap > max_gap:
                break
    meta.update(
        mission=mission, fromFrame=from_frame, toFrame=to_frame,
        downloaded=len(downloaded), missing=missing,
    )
    return downloaded, missing


# NASA aurora-videos index page listing curated sequence frame ranges
AURORA_VIDEOS_URL = (
    "https://eol.jsc.nasa.gov/ForFun/CrewEarthObservationsVideos/Aurora.htm"
)

def extract_aurora_sequences(url=AURORA_VIDEOS_URL):
    """Scrape the NASA aurora-videos index page for sequence frame ranges.

    The page lists each curated aurora sequence as a named anchor (title)
    followed by "<first frame> to <last frame>" photo.pl links; the
    mission/roll/frame query parameters of that link pair define the
    download range (reference eol.py:398-413 extractAuroraSequences).

    :returns: list of Sequence(mission, roll, from_frame, to_frame, title,
        url_anchor), ready to feed :func:`download_image_sequence` /
        :func:`download_image_sequence_raw`.
    """
    import re

    from auromat_tpu_torch.util.url import fetch_text

    html = fetch_text(url)
    link = r"photo\.pl\?mission=([A-Z0-9]+)&roll=([A-Z0-9]+)&frame=(\d+)"
    # ADJACENT '<first> to <last>' link pair: the closing </a> of the first
    # frame link, the literal word 'to', then the second link's opening tag
    # — anchored like the reference's pattern (ref eol.py:91-94), so stray
    # photo.pl links elsewhere in a section can never be mis-paired into a
    # bogus frame range
    # [^"&]* after frame=(digits): tolerate extra query parameters between
    # frame= and the closing quote (photo.pl links sometimes carry trailing
    # params) without letting the frame group swallow a later &frame=
    pair_re = re.compile(
        link + r'[^"]*"[^>]*>\s*(?:<nobr>)?[A-Z0-9-]*\s*</a>\s*to\s*<a\s[^>]*'
        + link, re.DOTALL | re.IGNORECASE)
    # legacy NASA HTML mixes attribute case/order (<A NAME=..>, id= before
    # name=): match any <a ...> tag carrying a name attribute
    # \s before name= so attributes merely ENDING in 'name'
    # (classname=, data-name=) don't make phantom anchors
    anchor_re = re.compile(
        r'<a\s(?:[^>]*\s)?name="([A-Za-z0-9_]+)"[^>]*>(.*?)</a>',
        re.DOTALL | re.IGNORECASE)
    # split the page at the named anchors; each section up to the next
    # anchor holds that sequence's frame-range pair
    anchors = list(anchor_re.finditer(html))
    sequences = []
    for i, m in enumerate(anchors):
        section_end = anchors[i + 1].start() if i + 1 < len(anchors) else len(html)
        section = html[m.end() : section_end]
        pair = pair_re.search(section)
        if pair is None:
            # surface skipped sections (navigation anchors are expected;
            # a real sequence section failing to parse should be visible)
            import logging
            logging.getLogger(__name__).info(
                "aurora-videos: no frame-range pair under anchor %r; skipped",
                m.group(1))
            continue
        mission_a, roll_a, frame_a, mission_b, roll_b, frame_b = pair.groups()
        if (mission_a, roll_a) != (mission_b, roll_b):
            # the reference asserts here (ref eol.py:410) — surface the
            # malformed section instead of silently mis-ranging
            raise ValueError(
                f"aurora-videos section {m.group(1)!r} pairs frames from "
                f"different missions/rolls: {mission_a}-{roll_a} to "
                f"{mission_b}-{roll_b}"
            )
        title = re.sub(r"<[^>]+>", "", m.group(2)).strip()
        sequences.append(Sequence(
            mission=mission_a, roll=roll_a,
            from_frame=int(frame_a), to_frame=int(frame_b),
            title=title, url_anchor=m.group(1),
        ))
    return sequences


def correct_lens_distortion(folder, out_folder, device="cuda", **kw):
    """Undistort every image of a folder on ``device`` (the card by
    default; reference eol.py:454-489). ``kw`` (``model``, ``params``) go
    to :func:`auromat_tpu_torch.util.lensdistortion.correct_lens_distortion`.
    """
    from auromat_tpu_torch.io.image import load_image, save_image
    from auromat_tpu_torch.ops.georef import compute_device
    from auromat_tpu_torch.util.lensdistortion import \
        correct_lens_distortion as correct

    device = compute_device(device)
    os.makedirs(out_folder, exist_ok=True)
    outputs = []
    for f in sorted(os.listdir(folder)):
        if os.path.splitext(f)[1].lower() not in (".jpg", ".jpeg", ".png", ".tif", ".tiff"):
            continue
        img = load_image(os.path.join(folder, f))
        corrected = correct(img, device=device, **kw)
        out = os.path.join(out_folder, f)
        save_image(out, corrected)
        outputs.append(out)
    return outputs


# ---------------------------------------------------------------------------
# RAW (NEF) ordering pipeline (reference eol.py:229-396)
# ---------------------------------------------------------------------------

# EOL endpoints; override (e.g. with a local test server) via the urls dict
RAW_URLS = {
    # HTML photo page carrying the RAW filename
    "photo_page": ("https://eol.jsc.nasa.gov/SearchPhotos/photo.pl"
                   "?mission={mission}&roll={roll}&frame={frame}"),
    # probing this tells whether the frame exists at all (200/404)
    "jpg": ("https://eol.jsc.nasa.gov/DatabaseImages/ESC/large/"
            "{mission}/{mission}-{roll}-{frame}.JPG"),
    # GET fires the server-side order that stages the RAW file
    "raw_request": ("https://eol.jsc.nasa.gov/OrderImages/requestImage.pl"
                    "?mission={mission}&roll={roll}&frame={frame}&file={file}"),
    # staged file location, available minutes after the request
    "raw": "https://eol.jsc.nasa.gov/OrderImages/{file}",
}

RAW_FILE_PHOTO_PAGE_RE = r'href="[^"]*?([\w.-]+\.(?:NEF|nef|CR2|cr2))"'


def _raw_filename_pattern(raw_filename, mission, roll, from_frame):
    """Derive the RAW filename template from one concrete example.

    EOL stores RAW names with inconsistent casing/zero-padding across
    missions; the reference derives the pattern from the first frame's
    photo page (eol.py:262-306). Returns (pattern, frame_formatter).
    """
    base, ext = os.path.splitext(raw_filename)
    pattern = base
    for cand in (mission, mission.lower()):
        if cand in pattern:
            pattern = pattern.replace(cand, "{mission}", 1)
            mission_cased = cand
            break
    else:
        raise RuntimeError(f"mission name not found in {base!r}")
    for cand in (roll, roll.lower()):
        if cand in pattern:
            pattern = pattern.replace(cand, "{roll}", 1)
            roll_cased = cand
            break
    else:
        raise RuntimeError(f"roll name not found in {base!r}")
    zfilled = str(from_frame).zfill(6)
    if zfilled in pattern:
        pattern = pattern.replace(zfilled, "{frame}", 1)
        frame_fn = lambda f: str(f).zfill(6)
    elif str(from_frame) in pattern:
        pattern = pattern.replace(str(from_frame), "{frame}", 1)
        frame_fn = str
    else:
        raise RuntimeError(f"frame number not found in {base!r}")
    full = pattern + ext

    def fmt(frame):
        return full.format(mission=mission_cased, roll=roll_cased,
                           frame=frame_fn(frame))

    return full, fmt


def download_image_sequence_raw(folder, mission, from_frame, to_frame,
                                roll="E", urls=None, batch_size=30,
                                poll_interval=30.0, stall_timeout=480.0,
                                sleep=None):
    """Order and download the RAW (NEF) files of a frame sequence.

    The EOL archive does not serve RAW files directly: each file must be
    ORDERED (a GET on the request endpoint), after which the server stages
    it "within 5 minutes or more". This mirrors the reference flow
    (eol.py:245-396): derive the RAW filename pattern from the first
    frame's photo page, probe the JPEG URLs for frame gaps, fire order
    requests in batches of ``batch_size``, then poll-download each batch
    until it drains or makes no progress for ``stall_timeout`` seconds.
    Files land in a temp subfolder and move over atomically; a metadata
    sidecar records the sequence (resume: a sidecar short-circuits).

    :param urls: endpoint template overrides (see RAW_URLS) — tests point
        these at a local fake server
    :param sleep: injectable sleep(seconds) for tests
    :returns: (SequenceMetadata, failures list); metadata is None when any
        frame failed
    """
    import re
    import shutil
    import time as _time

    from auromat_tpu_torch.util.url import (download_files, fetch_text,
                                            url_response_code)

    u = dict(RAW_URLS)
    u.update(urls or {})
    sleep = sleep or _time.sleep
    from_frame, to_frame = int(from_frame), int(to_frame)
    meta = SequenceMetadata(folder)
    # RAW-prefixed keys: the JPEG downloader shares the sidecar and writes
    # its own fromFrame/toFrame — trusting those would silently skip RAW
    # downloads after a JPEG run over a wider range
    if meta.get("raw") and meta.get("rawFromFrame") is not None \
            and meta["rawFromFrame"] <= from_frame \
            and meta.get("rawToFrame", -1) >= to_frame:
        # requested range already covered by a completed RAW download
        return meta, []
    tmp_folder = os.path.join(folder, "in_progress")
    os.makedirs(tmp_folder, exist_ok=True)

    page = fetch_text(u["photo_page"].format(mission=mission, roll=roll,
                                             frame=from_frame))
    m = re.search(RAW_FILE_PHOTO_PAGE_RE, page)
    if m is None:
        raise RuntimeError("could not find RAW filename on the photo page")
    _, fmt = _raw_filename_pattern(m.group(1), mission, roll, from_frame)

    disk_name = lambda f: f"{mission}-{roll}-{f}" + os.path.splitext(
        m.group(1))[1].lower()

    frames = range(from_frame, to_frame + 1)
    frame_gaps, failures, queue = [], [], []
    for frame in frames:
        path = os.path.join(tmp_folder, disk_name(frame))
        final = os.path.join(folder, disk_name(frame))
        if os.path.exists(path) or os.path.exists(final):
            continue
        jpg_url = u["jpg"].format(mission=mission, roll=roll, frame=frame)
        try:
            code = url_response_code(jpg_url)
        except Exception as e:
            failures.append((jpg_url, e))
            continue
        if code == 200:
            raw_file = fmt(frame)
            queue.append((
                u["raw"].format(file=raw_file),
                u["raw_request"].format(mission=mission, roll=roll,
                                        frame=frame, file=raw_file),
                path,
            ))
        elif code == 404:
            if from_frame < frame < to_frame:
                frame_gaps.append(frame)
            else:
                raise ValueError(
                    f"start/end frame {frame} not downloadable (404)")
        else:
            failures.append((jpg_url, code))

    for i in range(0, len(queue), batch_size):
        batch = queue[i : i + batch_size]
        pairs = []
        for raw_url, request_url, path in batch:
            try:
                code = url_response_code(request_url)
            except Exception as e:
                failures.append((raw_url, e))
                continue
            if code == 200:
                pairs.append((raw_url, path))
            else:
                failures.append((raw_url, code))
        # poll until the staged files drain or progress stalls
        pending = download_files(pairs, ignore_errors=True)
        last_progress = _time.monotonic()
        while pending and _time.monotonic() - last_progress < stall_timeout:
            sleep(poll_interval)
            n_before = len(pending)
            pending = download_files([(url, path) for url, path, _ in pending],
                                     ignore_errors=True)
            if len(pending) < n_before:
                last_progress = _time.monotonic()
        # normalize to the (url, error) shape of the probe/order failures
        failures.extend((url, err) for url, _path, err in pending)

    if failures:
        return None, failures

    for name in os.listdir(tmp_folder):
        shutil.move(os.path.join(tmp_folder, name), os.path.join(folder, name))
    os.rmdir(tmp_folder)
    prev_from = meta.get("rawFromFrame")
    prev_to = meta.get("rawToFrame")
    prev_gaps = meta.get("rawFrameGaps", []) if meta.get("raw") else []
    meta.update(
        mission=mission, roll=roll,
        rawFromFrame=from_frame if prev_from is None
        else min(prev_from, from_frame),
        rawToFrame=to_frame if prev_to is None else max(prev_to, to_frame),
        rawFrameGaps=sorted(set(prev_gaps) | set(frame_gaps)),
        raw=True, pattern=disk_name(0).replace("-0.", "-{frame}."),
        lensDistortionCorrected=False)
    return meta, []


JPEG_FILE_PATTERN = "{mission}-{roll}-{frame}.jpg"
JPEG_URL_PATTERN = (
    "https://eol.jsc.nasa.gov/DatabaseImages/ESC/large/{mission}/"
    "{mission}-{roll}-{frame}.JPG"
)


def filename_of(frame, meta):
    """Filename for a frame of a downloaded sequence (reference
    eol.py:437-443). RAW sidecars carry the on-disk ``pattern`` derived
    from the photo page (with mission/roll already substituted, {frame}
    open); JPEG sequences use the frame_id convention."""
    pattern = meta.get("pattern")
    if pattern:
        return pattern.format(mission=meta.get("mission"),
                              roll=meta.get("roll"), frame=frame)
    return frame_id(meta["mission"], frame) + ".jpg"


def frame_iter(meta):
    """Frames of a sequence, skipping recorded gaps (reference
    eol.py:445-448). Reads both sidecar layouts: JPEG sequences
    (fromFrame/toFrame/missing) and RAW orders
    (rawFromFrame/rawToFrame/rawFrameGaps)."""
    start = meta.get("fromFrame", meta.get("rawFromFrame"))
    stop = meta.get("toFrame", meta.get("rawToFrame"))
    if start is None or stop is None:
        raise KeyError("sequence sidecar has no fromFrame/rawFromFrame range")
    skip = set(meta.get("missing", ())) | set(meta.get("rawFrameGaps", ()))
    for frame in range(start, stop + 1):
        if frame not in skip:
            yield frame


def filename_iter(meta):
    """(filename, frame) pairs of a sequence (reference eol.py:450-452)."""
    for frame in frame_iter(meta):
        yield filename_of(frame, meta), frame


def download_images(folder, ids, format_="jpg"):
    """Download images given by (mission, roll, frame) tuples (reference
    eol.py:96-114; like there, only JPEG supports per-id download — RAW
    frames ride the order/poll batch flow, download_image_sequence_raw)."""
    if format_ == "jpg":
        return download_images_jpg(folder, ids)
    if format_ == "raw":
        raise NotImplementedError(
            "per-id RAW download: use download_image_sequence_raw")
    raise ValueError(f"unknown format: {format_}")


def download_images_jpg(folder, ids):
    """Download JPEGs for (mission, roll, frame) tuples; skip existing
    files; return paths, or False on any error (reference eol.py:116-139).
    """
    os.makedirs(folder, exist_ok=True)
    paths = []
    for mission, roll, frame in ids:
        path = os.path.join(folder, JPEG_FILE_PATTERN.format(
            mission=mission, roll=roll, frame=frame))
        if not os.path.exists(path):
            try:
                download_file(JPEG_URL_PATTERN.format(
                    mission=mission, roll=roll, frame=frame), path)
            except DownloadError:
                return False
        paths.append(path)
    return paths
