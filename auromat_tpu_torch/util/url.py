"""Download helpers with retry and atomic writes.

Mirrors auromat/util/url.py, a copy of ``auromat_tpu.util.url``: one
retry, unified DownloadError, atomic .tmp rename, batch downloads with
failure lists, response-code probes and small text fetches (the online
providers and the EOL downloaders call them; offline modes never do).
"""

import json
import os
import shutil
import urllib.error
import urllib.request


class DownloadError(Exception):
    pass


def download_file(url, path, unify_errors=True, timeout=60):
    """Download ``url`` to ``path`` atomically (via .tmp), retrying once."""
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    last = None
    for _ in range(2):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(tmp, path)
            return path
        except urllib.error.HTTPError as e:
            if not unify_errors:
                raise
            last = e
        except Exception as e:  # URLError, socket timeouts, disk errors
            last = e
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    raise DownloadError(f"failed to download {url}: {last!r}")


def download_json(url, timeout=60):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.load(r)
    except Exception as e:
        raise DownloadError(f"failed to download {url}: {e!r}")


def download_files(url_path_pairs, ignore_errors=False):
    """Download many files; return the list of (url, path, error) failures."""
    failures = []
    for url, path in url_path_pairs:
        try:
            download_file(url, path)
        except DownloadError as e:
            if not ignore_errors:
                raise
            failures.append((url, path, e))
    return failures


def url_response_code(url, timeout=60):
    """HTTP status code of a GET without downloading the body (retries
    once on transport errors, like download_file).

    Reference: auromat/util/url.py urlResponseCode (used by the EOL RAW
    flow to probe frame existence and to fire order requests).
    """
    req = urllib.request.Request(url, method="GET")
    last = None
    for _ in range(2):
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except Exception as e:  # transport errors: retry once
            last = e
    raise DownloadError(f"failed to reach {url}: {last!r}")


def fetch_text(url, timeout=60):
    """Fetch a small text resource (e.g. an HTML photo page); one retry."""
    last = None
    for _ in range(2):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.read().decode("utf-8", errors="replace")
        except Exception as e:
            last = e
    raise DownloadError(f"failed to fetch {url}: {last!r}")


def download_resource(url, fn, unify_errors=True, timeout=60):
    """Fetch ``url`` and return ``fn(response_bytes)``; retry once on
    transient errors, 404 raises immediately (reference url.py:69-93)."""
    last = None
    for attempt in range(2):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return fn(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                if unify_errors:
                    raise DownloadError(e)
                raise
            last = e
        except Exception as e:  # URLError, socket timeouts
            last = e
    if unify_errors:
        raise DownloadError(f"failed to fetch {url}: {last!r}")
    raise last
