"""Batch-mode ExifTool client.

Counterpart of ``auromat_tpu.util.exiftool``, the same code; its tags
feed :func:`auromat_tpu_torch.util.lensdistortion.lookup_from_exif`.

The reference vendors PyExifTool (auromat/util/exiftool.py:16-20) with two
additions: a ``nums`` flag (numeric tag values) and ``copy_tags``. This is a
fresh minimal implementation of the same surface: one long-lived `exiftool
-stay_open` subprocess answers many queries without per-file process spawns
(RAW workflows read EXIF for thousands of frames).

Gated on the external binary: constructing :class:`ExifTool` raises
``RuntimeError`` if ``exiftool`` is not on PATH.
"""

import json
import os
import shutil
import subprocess

_SENTINEL = b"{ready}"


class ExifTool:
    """Long-lived ``exiftool -stay_open True`` process.

    Usage::

        with ExifTool() as et:
            meta = et.get_metadata("frame.NEF")
            et.copy_tags("frame.NEF", "frame.jpg")
    """

    def __init__(self, executable="exiftool", nums=True):
        if shutil.which(executable) is None:
            raise RuntimeError(
                f"{executable!r} not found on PATH; install exiftool to use "
                "RAW metadata workflows"
            )
        self.executable = executable
        # process-wide numeric-values flag: exiftool has no per-command
        # reversal of -common_args ('--n' means "exclude tag n", not
        # "undo -n") — the reference makes this a constructor flag too
        self.nums = nums
        self._process = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self.running:
            return self
        self._process = subprocess.Popen(
            [self.executable, "-stay_open", "True", "-@", "-",
             "-common_args", "-G"] + (["-n"] if self.nums else []),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        return self

    @property
    def running(self):
        return self._process is not None and self._process.poll() is None

    def terminate(self):
        if not self.running:
            return
        try:
            self._process.stdin.write(b"-stay_open\nFalse\n")
            self._process.stdin.flush()
            self._process.communicate(timeout=5)
        except Exception:
            self._process.kill()
        self._process = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.terminate()

    # -- commands ----------------------------------------------------------
    def execute(self, *args):
        """Run one exiftool command in the persistent process; returns raw
        stdout bytes."""
        if not self.running:
            self.start()
        cmd = b"\n".join(a.encode() if isinstance(a, str) else a
                         for a in args)
        self._process.stdin.write(cmd + b"\n-execute\n")
        self._process.stdin.flush()
        out = b""
        while not out.rstrip(b"\r\n").endswith(_SENTINEL):
            chunk = self._process.stdout.read1(65536)
            if not chunk:
                # process died before emitting the sentinel — slicing the
                # sentinel length off real output would truncate it
                raise RuntimeError(
                    "exiftool process ended mid-response "
                    f"(exit code {self._process.poll()})")
            out += chunk
        return out.rstrip(b"\r\n")[: -len(_SENTINEL)].rstrip(b"\r\n")

    def get_metadata_batch(self, paths, tags=None):
        """JSON metadata dicts for many files in one exchange.

        :param tags: restrict to these tag names (no leading dash); numeric
            vs printable values follow the ``nums`` flag
        """
        args = ["-j"]
        if tags:
            args.extend("-" + t for t in tags)
        args.extend(os.fspath(p) for p in paths)
        out = self.execute(*args)
        return json.loads(out.decode("utf-8", "replace")) if out else []

    def get_metadata(self, path, tags=None):
        res = self.get_metadata_batch([path], tags=tags)
        return res[0] if res else {}

    def get_tag(self, path, tag):
        meta = self.get_metadata(path, tags=[tag])
        for key, value in meta.items():
            if key.split(":")[-1] == tag:
                return value
        return None

    def copy_tags(self, from_path, to_path, tags=None):
        """Copy EXIF tags between files (reference addition: used to carry
        camera metadata from NEF originals onto derived JPEGs)."""
        args = ["-overwrite_original", "-TagsFromFile", os.fspath(from_path)]
        if tags:
            args.extend("-" + t for t in tags)
        else:
            args.append("-all:all")
        args.append(os.fspath(to_path))
        return self.execute(*args)
