"""Stand-ins for the solving path, shared by ``tests/test_torch_solving.py``,
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

A POSIX ``sh`` stand-in for astrometry.net's ``solve-field`` and its call
log, a ``/proc`` scan for the live members of a process group, and a WCS
header turned to look straight down or up from the camera. Standard
library and numpy only (no jax, nothing of either package), so
``chip_smoke.py`` loads it by path on a machine without jax.
"""

import os
import stat

import numpy as np


def fake_solve_field(folder, wcs_src, exit_code=0, sleep=0):
    """Write a stand-in ``solve-field`` into ``folder`` and return its path.

    Each call appends ``<its process id> <image>`` to ``folder/calls.txt``,
    sleeps ``sleep`` s, copies ``wcs_src`` to ``<--dir>/<image base>.wcs``
    as astrometry.net would write it, and exits with ``exit_code``.
    """
    folder = str(folder)
    path = os.path.join(folder, f"solve-field-{exit_code}-{sleep}")
    with open(path, "w") as f:
        f.write("#!/bin/sh\n"
                f'echo "$$ $1" >> {folder}/calls.txt\n'
                f"sleep {sleep}\n"
                'img="$1"; shift\n'
                'dir=""\n'
                'while [ $# -gt 0 ]; do if [ "$1" = "--dir" ]; then '
                'dir="$2"; fi; shift; done\n'
                f'cp {wcs_src} "$dir/$(basename "${{img%.*}}").wcs"\n'
                f"exit {exit_code}\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def solver_calls(folder):
    """The stand-in's calls logged in ``folder``: (process id, image)."""
    path = os.path.join(str(folder), "calls.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [(int(pid), img) for pid, img in
                (line.split(" ", 1) for line in f.read().splitlines())]


def live_group_members(pgid):
    """Processes of group ``pgid`` that are still running (not zombies),
    read from Linux's /proc."""
    live = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            live.append(int(pid))
    return live


def unstamped(header):
    """``header`` without its POS*, DATESHIF and NORADID cards (what
    astrometry.net hands back), comments kept."""
    bare = type(header)({k: v for k, v in header.items()
                         if not k.startswith(("POS", "DATESHIF", "NORADID"))})
    bare.comments = {k: v for k, v in header.comments.items() if k in bare}
    return bare


def pointed(header, pos, sign):
    """``header`` turned to look along ``sign`` * the camera position
    ``pos``: -1 straight down (every ray of a narrow field meets the
    Earth), +1 straight up (none does)."""
    h = header.copy()
    d = sign * np.asarray(pos, dtype=np.float64) / np.linalg.norm(pos)
    h["CRVAL1"] = float(np.degrees(np.arctan2(d[1], d[0])) % 360)
    h["CRVAL2"] = float(np.degrees(np.arcsin(d[2])))
    return h
