"""Movie encoding from image frame sequences via ffmpeg.

Mirrors auromat/util/movie.py:15-90 (mp4/libx264 and webm/libvpx encodes
from a directory of frames, using a symlinked sequential naming scheme).
A copy of ``auromat_tpu.util.movie``.
"""

import os
import shutil
import subprocess
import tempfile


def create_movie(movie_path, frame_paths, fps=25, width=None, crf=None,
                 ffmpeg="ffmpeg"):
    """Encode ordered frame image paths into an .mp4 or .webm movie.

    :param width: optional output width (height follows aspect, even)
    :param crf: constant rate factor (quality; codec-specific default)
    """
    if shutil.which(ffmpeg) is None:
        raise RuntimeError("ffmpeg binary not found on PATH")
    ext = os.path.splitext(movie_path)[1].lower()
    if ext == ".mp4":
        codec_args = ["-c:v", "libx264", "-pix_fmt", "yuv420p",
                      "-crf", str(crf if crf is not None else 20)]
    elif ext == ".webm":
        codec_args = ["-c:v", "libvpx", "-crf", str(crf if crf is not None else 10),
                      "-b:v", "2M"]
    else:
        raise ValueError(f"unsupported movie container {ext!r}")

    tmp = tempfile.mkdtemp(prefix="auromat_movie_")
    try:
        ext_in = os.path.splitext(frame_paths[0])[1]
        for i, p in enumerate(frame_paths):
            os.symlink(os.path.abspath(p), os.path.join(tmp, f"{i:08d}{ext_in}"))
        filters = []
        if width:
            filters += ["-vf", f"scale={width}:trunc(ow/a/2)*2"]
        else:
            # libx264/yuv420p requires even dimensions; odd source frames
            # would fail with 'width not divisible by 2'
            filters += ["-vf", "scale=trunc(iw/2)*2:trunc(ih/2)*2"]
        cmd = [
            ffmpeg, "-y", "-framerate", str(fps),
            "-i", os.path.join(tmp, f"%08d{ext_in}"),
            *codec_args, *filters, movie_path,
        ]
        proc = subprocess.run(cmd, capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"ffmpeg failed ({proc.returncode}): "
                + proc.stderr.decode(errors="replace")[-2000:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return movie_path
