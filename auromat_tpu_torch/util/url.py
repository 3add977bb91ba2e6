"""Download with one retry and an atomic write (auromat/util/url.py).

Only the THEMIS provider's online mode calls it; ``offline=True`` never
does.
"""

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
