"""astrometry.net ``solve-field`` runner.

Host-side subprocess orchestration (reference auromat/solving/solving.py):
star-field masking feeds a masked image to astrometry.net; a strategy ladder
varies the source-extraction settings until a solution is found; solver runs
are bounded by a timeout with process-group kill; the resulting ``.wcs``
header is read back.

The astrometry.net binaries are external dependencies (as in the reference,
SURVEY.md 2b); all invocation logic is testable against a stand-in binary.
Counterpart of ``auromat_tpu.solving.solving``, over the port's ``io.fits``,
``io.image`` (PIL, imported where an image is read or written) and
``solving.masking`` (no OpenCV: the masking's pixel stages and its Hough
transform run on ``device``, the card by default).
"""

import os
import shutil
import signal
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from auromat_tpu_torch.io import fits
from auromat_tpu_torch.io.image import (load_image, read_focal_length_35mm,
                                        save_image)
from auromat_tpu_torch.solving.masking import mask_starfield

# source-extraction strategy ladder (reference solving.py:264-309):
# downsample-2 -> downsample-4 -> SExtractor -> no downsampling
STRATEGIES = [
    {"name": "xy2", "args": ["--downsample", "2"]},
    {"name": "xy4", "args": ["--downsample", "4"]},
    {"name": "sextractor", "args": ["--use-source-extractor"]},
    {"name": "xy", "args": []},
]


def estimate_arcsec_range(image_path, image_width):
    """(low, high) arcsec/px bounds from the EXIF 35mm focal length.

    For a 35mm-equivalent focal length f, the horizontal field is
    2*atan(18/f); divide by width for deg/px (reference solving.py:333-347).
    """
    f35 = read_focal_length_35mm(image_path)
    if not f35:
        return None
    fov_deg = np.rad2deg(2 * np.arctan(18.0 / f35))
    arcsec_per_px = fov_deg * 3600.0 / image_width
    return arcsec_per_px * 0.85, arcsec_per_px * 1.15


def build_solve_command(image_path, out_dir, scale_range=None, sigma=None,
                        timeout_cpu=300, pixel_error=10, no_tweak=True,
                        extra_args=(), solve_field="solve-field"):
    """Assemble the solve-field command line (reference solving.py:399-457)."""
    cmd = [
        solve_field, image_path,
        "--dir", out_dir,
        "--no-plots",
        "--overwrite",
        "--crpix-center",
        "--cpulimit", str(timeout_cpu),
        "--pixel-error", str(pixel_error),
    ]
    if no_tweak:
        cmd.append("--no-tweak")
    if scale_range:
        cmd += ["--scale-units", "arcsecperpix",
                "--scale-low", f"{scale_range[0]:.3f}",
                "--scale-high", f"{scale_range[1]:.3f}"]
    if sigma is not None:
        cmd += ["--sigma", f"{sigma:.2f}"]
    cmd += list(extra_args)
    return cmd


def run_with_timeout(cmd, timeout):
    """Run a command in its own process group; on timeout, SIGTERM then
    SIGKILL the whole group (reference solving.py:484-514 uses psutil; a
    process group achieves the same without it).

    :returns: (returncode or None on timeout, stdout, stderr)
    """
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass  # unkillable (e.g. D-state on a dead mount)
        except ProcessLookupError:
            pass
        finally:
            # drain/close the pipes of the killed child so fds don't
            # accumulate over a long solve run
            for stream in (proc.stdout, proc.stderr):
                if stream is not None:
                    try:
                        stream.close()
                    except OSError:
                        pass
        return None, b"", b"timeout"


def solve_image(image_path, wcs_path=None, mask=True, channel=None,
                timeout=600, scale_range=None, solve_field="solve-field",
                strategies=None, work_dir=None, verbose=False, device="cuda"):
    """Blind-solve one image; write the ``.wcs`` header next to it.

    :param mask: run automatic star-field masking first
    :param device: where ``mask_starfield`` computes (the card by default;
        raises if it is CUDA and there is none)
    :param scale_range: (low, high) arcsec/px; default from EXIF
    :returns: path of the .wcs file, or None if unsolved
    """
    if shutil.which(solve_field) is None:
        raise RuntimeError(
            f"astrometry.net binary {solve_field!r} not found on PATH; "
            "install astrometry.net or pass solve_field="
        )
    wcs_path = wcs_path or os.path.splitext(image_path)[0] + ".wcs"
    img = load_image(image_path)
    sigma = None
    solver_input = image_path
    if mask:  # before the temp dir: a masking that raises leaves none
        m, sigma = mask_starfield(img, channel=channel, device=device)
    own_tmp = work_dir is None
    tmp_dir = work_dir or tempfile.mkdtemp(prefix="auromat_solve_")
    if mask:
        masked = img.copy()
        masked[~m] = 0
        # unique per image: a shared work_dir under the solve_images
        # thread pool must not race on one fixed "masked.png" (a thread
        # could solve ANOTHER image's pixels and record its WCS)
        base = os.path.splitext(os.path.basename(image_path))[0]
        solver_input = os.path.join(tmp_dir, f"{base}_masked.png")
        save_image(solver_input, masked)
    if scale_range is None:
        scale_range = estimate_arcsec_range(image_path, img.shape[1])

    try:
        for strategy in strategies or STRATEGIES:
            cmd = build_solve_command(
                solver_input, tmp_dir, scale_range=scale_range, sigma=sigma,
                extra_args=strategy["args"], solve_field=solve_field,
            )
            t0 = time.time()
            code, out, err = run_with_timeout(cmd, timeout)
            if verbose:
                print(f"[{strategy['name']}] rc={code} dt={time.time()-t0:.1f}s")
            produced = os.path.join(
                tmp_dir,
                os.path.splitext(os.path.basename(solver_input))[0] + ".wcs"
            )
            if code == 0 and os.path.exists(produced):
                shutil.copy(produced, wcs_path)
                header = fits.read_header(wcs_path)
                header["IMAGEW"] = img.shape[1]
                header["IMAGEH"] = img.shape[0]
                fits.write_header(header, wcs_path)
                return wcs_path
        return None
    finally:
        if own_tmp:
            # a 2000-frame run would otherwise leak a multi-MB masked PNG
            # + solver products per frame into /tmp (reference rmtree's,
            # solving.py:329/513/533)
            shutil.rmtree(tmp_dir, ignore_errors=True)


def solve_images(image_paths, max_workers=None, **kw):
    """Thread-pool fan-out over solve_image — parallelism is effective
    because the solver is an external process (reference solving.py:44-87).
    ``kw`` goes to each ``solve_image`` (``device`` among them).

    :returns: dict image_path -> wcs_path or None
    """
    results = {}
    with ThreadPoolExecutor(max_workers=max_workers or os.cpu_count()) as ex:
        futures = {p: ex.submit(solve_image, p, **kw) for p in image_paths}
        for p, f in futures.items():
            try:
                results[p] = f.result()
            except Exception:
                results[p] = None
    return results
