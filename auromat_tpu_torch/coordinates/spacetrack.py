"""space-track.org TLE archive client.

Counterpart of ``auromat_tpu.coordinates.spacetrack``, the same code.

Mirrors auromat/coordinates/spacetrack.py: downloads/appends TLEs per NORAD
id into a local archive file, with a minimum update interval and checksum
filtering. Network access is isolated here; everything else consumes plain
TLE files via auromat_tpu_torch.coordinates.ephem.
"""

import os
import urllib.parse
import urllib.request
from datetime import datetime, timedelta

from auromat_tpu_torch.coordinates.ephem import parse_tle_file, tle_checksum_ok
from auromat_tpu_torch.util.url import DownloadError

BASE_URL = "https://www.space-track.org"
LOGIN_URL = BASE_URL + "/ajaxauth/login"
QUERY_URL = (
    BASE_URL + "/basicspacedata/query/class/tle/NORAD_CAT_ID/{norad}/"
    "EPOCH/{start}--{end}/orderby/EPOCH asc/format/tle"
)


class Spacetrack:
    """TLE downloader with a local per-satellite archive.

    :param tle_dir: folder for ``<norad>.tle`` archive files
    :param min_update_interval: re-query at most this often
    """

    def __init__(self, user, password, tle_dir,
                 min_update_interval=timedelta(hours=12)):
        self.user = user
        self.password = password
        self.tle_dir = tle_dir
        self.min_update_interval = min_update_interval
        self._cookie = None
        os.makedirs(tle_dir, exist_ok=True)

    def tle_path(self, norad_id):
        return os.path.join(self.tle_dir, f"{norad_id}.tle")

    def _login(self):
        if self._cookie is not None:
            return
        data = urllib.parse.urlencode(
            {"identity": self.user, "password": self.password}
        ).encode()
        req = urllib.request.Request(LOGIN_URL, data=data)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                cookie = r.headers.get("Set-Cookie")
                if not cookie:
                    raise DownloadError("space-track login returned no cookie")
                self._cookie = cookie.split(";")[0]
        except Exception as e:
            raise DownloadError(f"space-track login failed: {e!r}")

    def query(self, norad_id, start: datetime, end: datetime) -> str:
        """Raw TLE text for the satellite in [start, end]."""
        self._login()
        url = QUERY_URL.format(
            norad=norad_id, start=start.strftime("%Y-%m-%d"),
            end=end.strftime("%Y-%m-%d"),
        )
        req = urllib.request.Request(url, headers={"Cookie": self._cookie})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.read().decode("ascii", "replace")
        except Exception as e:
            raise DownloadError(f"space-track query failed: {e!r}")

    def update_tles_for(self, norad_id, dates):
        """Ensure the archive covers all given dates (+- 2 days margin)."""
        if not dates:
            return self.tle_path(norad_id)
        return self.update_tles(norad_id, min(dates) - timedelta(days=2),
                                max(dates) + timedelta(days=2))

    # reference API aliases (spacetrack.py:44-92)
    updateTLEsFor = update_tles_for

    # TLEs for an active satellite publish several per day; a hole wider
    # than this inside the requested range means the archive has a gap
    # (disjoint ranges appended over time) and must be re-queried
    MAX_EPOCH_GAP = timedelta(days=7)

    def _covers(self, path, start, end):
        """Archive covers [start, end]: epochs (SORTED — the file is
        append-ordered and may hold disjoint ranges) reach both endpoints
        with no interior gap. ``end`` is clamped to now: no published TLE
        can have a future epoch, so a raw future end would defeat the
        min_update_interval for current-epoch satellites (re-login +
        re-query per call — space-track rate limits)."""
        try:
            tles = parse_tle_file(path)
        except Exception:
            return False
        if not tles:
            return False
        epochs = sorted(t.epoch for t in tles)
        eff_end = min(end, datetime.now())
        # pure gap criterion with MAX_EPOCH_GAP slack at both endpoints:
        # the newest published TLE always lags now by hours (an exact
        # epochs[-1] >= now can never hold), and a TLE shortly before
        # start serves the start of the range the same way
        near = [e for e in epochs
                if start - self.MAX_EPOCH_GAP <= e
                <= eff_end + self.MAX_EPOCH_GAP]
        if not near:
            return False
        seq = [start] + near + [eff_end]
        return all(b - a <= self.MAX_EPOCH_GAP for a, b in zip(seq, seq[1:]))

    @staticmethod
    def _checksum_filter(lines):
        """Keep whole TLE ENTRIES whose lines all pass the checksum —
        filtering single lines would orphan the partner line, which
        parse_tle_file then misreads as a name line of the next TLE."""
        good = []
        name = None
        i = 0
        while i < len(lines):
            line = lines[i]
            if line.startswith("1 "):
                if (i + 1 < len(lines) and lines[i + 1].startswith("2 ")
                        and tle_checksum_ok(line)
                        and tle_checksum_ok(lines[i + 1])):
                    if name is not None:
                        good.append(name)
                    good.extend([line, lines[i + 1]])
                i += 2 if (i + 1 < len(lines)
                           and lines[i + 1].startswith("2 ")) else 1
                name = None
            elif line.startswith("2 "):
                i += 1  # orphan line 2: drop
                name = None
            else:
                name = line  # 3-line format name, kept only with its pair
                i += 1
        return good

    def update_tles(self, norad_id, start, end):
        path = self.tle_path(norad_id)
        stamp = path + ".stamp"
        if os.path.exists(stamp) and os.path.exists(path):
            mtime = datetime.fromtimestamp(os.path.getmtime(stamp))
            if (datetime.now() - mtime < self.min_update_interval
                    and self._covers(path, start, end)):
                return path
        text = self.query(norad_id, start, end)
        lines = [l for l in text.splitlines() if l.strip()]
        good = self._checksum_filter(lines)
        existing = set()
        if os.path.exists(path):
            with open(path) as f:
                existing = set(l.rstrip("\n") for l in f)
        new = [l for l in good if l not in existing]
        if new:
            with open(path, "a") as f:
                f.write("\n".join(new) + "\n")
        with open(stamp, "w") as f:
            f.write(datetime.now().isoformat())
        return path

    updateTLEs = update_tles
